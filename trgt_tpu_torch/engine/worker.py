"""A worker process of `genotype -t N` (counterpart of
`trgt_tpu/engine/worker.py`, the answer to the reference's rayon pool,
ref commands/genotype.rs:140-199).

    python -m trgt_tpu_torch.engine.worker '<spec as JSON>'

The parent (engine/runner.py `WorkerPool`) spawns N workers and
hands out catalog chunks as they ask: a worker writes a request frame
(b'R') whenever it has fewer than two chunks outstanding, and the parent
answers on the worker's stdin with the next unassigned chunk [start,
start + count) of the (catalog-sharded) locus stream, first come first
served, so an expensive locus delays only its own worker. Chunks are
granted in ascending order, so each worker's stream indices ascend and
the parent's k-way merge by index reproduces the `-t 1` bytes exactly.

Each worker runs its own `BatchPipeline` on the requested device (its own
CUDA context under `--device cuda`) over the loci it was granted and
ships RENDERED records (VCF line bytes and length-prefixed BAM records,
made by the same code as the single-process writer) to the parent.

Frame protocol (little-endian), worker stdout:
  b'R'                                 (chunk request)
  b'L' u64 index  u32 vcf_len  u32 n_bam
       vcf bytes
       n_bam x [ u32 rec_len  i32 ref_id  i64 pos  i64 ref_end
                 rec bytes ]
  b'E' u64 n_ok  u64 n_err             (end of stream, stats)
Parent replies on worker stdin:
  i64 start  i64 count                 (count <= 0: no more work)

The frames go to the stdout the worker was started with; file descriptor
1 itself is pointed at stderr, so that nothing else the process prints (a
library, a kernel's printf) lands between two frames.
"""

import collections
import json
import logging
import os
import struct
import sys
import threading
import time

# loci a worker batches. A worker claims up to two batches ahead of its
# compute (batching and the extraction prefetch), and claimed loci are not
# handed on: a large batch turns the dynamic chunks back into static
# slices, and at 256 one worker took every locus of a 384-locus catalog.
# The host twins batch as the reference's host workers do.
DEVICE_BATCH = 32
HOST_BATCH = 4


def worker_main(spec: dict) -> int:
    from types import SimpleNamespace
    args = SimpleNamespace(**spec["args"])
    w = spec["worker_index"]
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)

    logging.basicConfig(
        level=spec.get("log_level", logging.WARNING),
        stream=sys.stderr,
        format=f"[worker {w}] %(levelname)s %(message)s")
    log = logging.getLogger("trgt")

    from .. import mesh
    from ..device import resolve_device
    from ..io.catalog import iter_loci
    from ..io.fasta import FastaReader
    from ..io.vcf_write import VcfWriter
    from ..kernels import telemetry
    from ..utils import Genotyper, Karyotype, TrgtScoring
    from .pipeline import STAGE_TIMES, BatchPipeline
    from .runner import iter_spanning_records, open_alignments
    from .workflow import Params

    device = resolve_device(args.device)
    karyotype = Karyotype.new(args.karyotype)
    genotyper = Genotyper.from_str(args.genotyper)
    scoring = TrgtScoring.from_string(args.aln_scoring)

    bam = open_alignments(args.reads_path, args.genome_path)
    tid_of = bam.header.tid
    genome = FastaReader(args.genome_path)
    output_flank_len = min(args.flank_len, args.output_flank_len)
    write_bam = not args.disable_bam_output

    params = Params(
        min_flank_id_frac=args.min_flank_id_frac,
        min_read_qual=args.min_hifi_read_qual,
        search_flank_len=args.flank_len,
        max_depth=args.max_depth,
        aln_scoring=scoring,
    )
    if device is not None:
        mesh.auto_enable(device.type)    # none unless TRGT_TPU_MESH asks

    n_err = 0

    def on_error(msg):
        nonlocal n_err
        log.error("Locus processing: %s", msg)
        n_err += 1

    default_batch = DEVICE_BATCH if device is not None else HOST_BATCH
    pipeline = BatchPipeline(
        params, device,
        batch_size=args.batch_size or default_batch,
        num_threads=1,
        bam_factory=lambda: open_alignments(args.reads_path,
                                            args.genome_path))

    loci = iter_loci(args.repeats_path, genome, karyotype, args.flank_len,
                     genotyper, on_error=on_error)
    if args.shard_count:
        loci = (locus for i, locus in enumerate(loci)
                if i % args.shard_count == args.shard_index)

    stdin = sys.stdin.buffer
    out_lock = threading.Lock()

    def request_chunk():
        with out_lock:
            out.write(b"R")
            out.flush()

    def read_chunk():
        hdr = stdin.read(16)
        if len(hdr) < 16:
            return None
        start, count = struct.unpack("<qq", hdr)
        if count <= 0:
            return None
        return start, count

    idxq = collections.deque()

    def granted():
        """The loci of the granted chunks, their stream indices queued in
        `idxq`. The stream is forward-only, so unassigned loci are parsed
        and skipped."""
        stream = enumerate(loci)
        pos = 0          # next stream index to read
        request_chunk()  # keep two chunks outstanding (double buffer)
        request_chunk()
        while True:
            chunk = read_chunk()
            if chunk is None:
                return
            start, count = chunk
            request_chunk()
            exhausted = False
            for j in range(start, start + count):
                locus = None
                while pos <= j:
                    nxt = next(stream, None)
                    if nxt is None:
                        exhausted = True
                        break
                    pos = nxt[0] + 1
                    if nxt[0] == j:
                        locus = nxt[1]
                if exhausted:
                    return
                if locus is not None:
                    idxq.append(j)
                    yield locus

    ready = time.time() - spec["spawned_at"]
    log.debug("worker ready %.3f s after spawn, device %s", ready, device)
    n_ok = 0
    for locus, results in pipeline.process(granted(), bam):
        j = idxq.popleft()
        vcf_line = VcfWriter.render(locus, results).encode("utf-8")
        recs = []
        if write_bam:
            # bytes() copies: the native encoder yields memoryviews into a
            # scratch buffer that the next record reuses
            recs = [(bytes(rec), rid, pos, ref_end)
                    for rec, rid, pos, ref_end in iter_spanning_records(
                        tid_of, locus, results, output_flank_len)]
        with out_lock:
            out.write(b"L" + struct.pack("<QII", j, len(vcf_line),
                                         len(recs)))
            out.write(vcf_line)
            for rec, rid, pos, ref_end in recs:
                out.write(struct.pack("<Iiqq", len(rec), rid, pos, ref_end))
                out.write(rec)
            out.flush()
        n_ok += 1
    with out_lock:
        out.write(b"E" + struct.pack("<QQ", n_ok, n_err))
        out.flush()
    log.debug("worker done %.3f s after spawn: %d loci, stages %s, kernels "
              "%s", time.time() - spec["spawned_at"], n_ok,
              json.dumps({k: round(v, 3) for k, v in STAGE_TIMES.items()}),
              json.dumps(telemetry.snapshot()))
    return 0


if __name__ == "__main__":
    sys.exit(worker_main(json.loads(sys.argv[1])))
