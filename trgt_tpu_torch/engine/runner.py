"""The port's `genotype` driver (counterpart of
`trgt_tpu/engine/runner.py:289 run_genotype`).

Stream loci → `BatchPipeline` → VCF + spanning BAM through the port's
own readers and writers, with a writer thread. `--device` picks CUDA
kernels, their plain PyTorch versions on the CPU, or the host twins
(device.py); a device run installs the device mesh that TRGT_TPU_MESH
asks for (`mesh.auto_enable`; none unless asked).

`-t N` with N > 1 runs N worker processes (engine/worker.py) where the
catalog gives each POOL_MIN_LOCI loci, each on the requested device with
a CUDA context of its own; they take catalog chunks as they ask for them,
and the parent spawns them before it imports torch and merges their
rendered records in catalog order, so the output bytes equal `-t 1`'s.
On a smaller catalog, and with TRGT_TPU_PROCS=0, one process runs and
`-t N` threads read extraction.
"""

import heapq
import itertools
import json
import logging
import os
import queue
import struct
import subprocess
import sys
import threading
import time
from typing import Optional

from .. import FULL_VERSION
from ..device import check_mode, resolve_device
from ..io.bam import BamReader
from ..io.bam_write import BamWriter, build_record, encode_bamlet_record
from ..io.catalog import iter_loci, open_catalog
from ..io.fasta import FastaReader
from ..io.vcf_write import VcfWriter
from ..reads import clip_bases
from ..utils import Genotyper, Karyotype, TrgtScoring
from .workflow import Params

log = logging.getLogger("trgt")
PROGRAM_NAME = "trgt"


def get_sample_name(reads_path: str, header) -> str:
    # ref: src/utils/bam_utils.rs:22-47
    names = header.sample_names()
    if len(names) == 1:
        return names[0]
    if len(names) == 0:
        log.warning("No sample names found")
    else:
        log.warning("Multiple sample names found")
    stem = os.path.basename(reads_path)
    for ext in (".bam", ".cram"):
        if stem.endswith(ext):
            stem = stem[:-len(ext)]
    return stem


def iter_spanning_records(tid_of, locus, results, flank_len: int):
    """Yield (length-prefixed record bytes, ref_id, pos, ref_end) for
    each spanning read of a locus (ref: src/trgt/writers/
    write_bam.rs:72-144)."""
    for index in range(len(results.reads)):
        read = results.reads[index]
        classification = results.classification[index]
        span = results.tr_spans[index]
        if span[0] < flank_len or len(read.bases) < span[1] + flank_len:
            log.error("Read %s has unexpectedly short flanks", read.id)
            continue
        left_clip = span[0] - flank_len
        right_clip = len(read.bases) - span[1] - flank_len
        clipped = clip_bases(read, left_clip, right_clip)
        if clipped is None:
            log.error("Read %s has unexpectedly short flanks", read.id)
            continue
        read = clipped
        contig_id = tid_of(locus.region.contig)

        flag = 0x10 if read.is_reverse else 0
        if read.cigar is not None:
            pos = read.cigar.ref_pos
            cigar = read.cigar.ops
            mapq = read.mapq
        else:
            pos = locus.region.start
            cigar = None
            flag |= 0x4
            mapq = 0  # htslib's zero-initialized record default

        rq = read.read_qual if read.read_qual is not None else -1.0
        rec = encode_bamlet_record(
            read.id, flag, contig_id, pos, mapq, cigar, read.bases,
            read.quals, locus.id, rq, read.meth, read.mismatch_offsets,
            read.hp_tag, read.start_offset, read.end_offset,
            classification, flank_len)
        if rec is not None:
            ref_span = sum(length for length, op in (cigar or [])
                           if op in "MDN=X")
            yield rec, contig_id, pos, pos + ref_span
            continue
        aux = [("TR", "Z", locus.id),
               ("rq", "f", rq)]
        if read.meth is not None:
            aux.append(("MC", "B", ("C", read.meth)))
        if read.mismatch_offsets is not None:
            aux.append(("MO", "B", ("i", read.mismatch_offsets)))
        if read.hp_tag is not None:
            aux.append(("HP", "C", read.hp_tag))
        aux.append(("SO", "i", read.start_offset))
        aux.append(("EO", "i", read.end_offset))
        aux.append(("AL", "i", classification))
        aux.append(("FL", "B", ("I", [flank_len, flank_len])))

        rec_b, ref_end = build_record(read.id, flag, contig_id, pos, mapq,
                                      cigar, read.bases.decode(),
                                      read.quals, aux)
        yield rec_b, contig_id, pos, ref_end


def write_spanning_reads(bam_writer: BamWriter, locus, results,
                         flank_len: int) -> None:
    for rec, rid, pos, ref_end in iter_spanning_records(
            bam_writer.header.tid, locus, results, flank_len):
        bam_writer.write_encoded(rec, rid, pos, ref_end)


def open_alignments(reads_path: str, genome_path: Optional[str] = None):
    """BAM or CRAM reader by magic sniffing (ref: rust-htslib
    IndexedReader::from_path + set_reference, commands/genotype.rs:46)."""
    with open(reads_path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"CRAM":
        from ..io.cram import CramReader   # large; only for CRAM input
        return CramReader(reads_path, genome_path)
    return BamReader(reads_path)


# the package's root directory, put on the workers' PYTHONPATH
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _worker_spec(args, wk: int, level: int) -> dict:
    """What worker `wk` is told: every CLI argument as given, so every
    worker runs on the requested device. A record then never depends on
    which worker drew its locus, where `cuda` and `host` differ (the f32
    and f64 Viterbi, ROADMAP C4)."""
    return {"args": dict(vars(args)), "worker_index": wk, "log_level": level,
            "spawned_at": time.time()}


def _worker_argv(spec: dict) -> list:
    return [sys.executable, "-m", "trgt_tpu_torch.engine.worker",
            json.dumps(spec)]


def _read_exact(fh, k: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < k:
        chunk = fh.read(k - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


# loci a grant: small, so that an expensive locus delays only its worker
CHUNK = 2
# catalog loci a worker needs for `-t N` to start the pool: a worker's
# start-up (a torch import and a CUDA context, 7-12 s on the H100) is paid
# back only over enough loci. At 96 loci -t 4 read within the spread of the
# threads, at 2048 2.4-2.9x their loci/s (PERF.md, chip_profile.py pool).
POOL_MIN_LOCI = 64


def use_pool(args) -> bool:
    """Whether `-t N` runs N worker processes: N > 1, not TRGT_TPU_PROCS=0,
    and a catalog (or catalog shard) of POOL_MIN_LOCI loci a worker."""
    if args.num_threads <= 1 or os.environ.get("TRGT_TPU_PROCS") == "0":
        return False
    need = POOL_MIN_LOCI * args.num_threads * (args.shard_count or 1)
    with open_catalog(args.repeats_path) as fh:
        lines = (line for line in fh if line.strip())
        return sum(1 for _ in itertools.islice(lines, need)) >= need


class WorkerPool:
    """`nproc` worker processes (engine/worker.py), spawned at once, with a
    reader thread each that answers the worker's chunk requests: the first
    to ask gets the next chunk (the work distribution of the reference's
    rayon pool, commands/genotype.rs:178-187). `merge` k-way merges their
    framed records by catalog stream index. Chunks are granted in
    ascending order, so each worker's indices ascend and the merge
    reproduces the `-t 1` byte order exactly. If a worker fails, `stop`
    kills the others and closes their pipes before the failure is
    raised."""

    def __init__(self, args, nproc: int):
        if args.device == "cuda":
            from ..kernels import _build
            if not os.path.exists(_build.library_path()):
                # a first run of these sources: check the card before
                # nvcc, and build once, before N workers would each run it
                check_mode(args.device)
                _build.build()
        level = logging.getLogger("trgt").getEffectiveLevel()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
        self.procs = []
        self.readers = []
        self.stats = [None] * nproc
        self.failure = []                 # the first reader's error
        self.grant_lock = threading.Lock()
        self.next_start = 0
        # one reader thread per worker: the merge takes indices in strict
        # interleave, so without buffering a worker would stall on a full
        # pipe whenever a sibling lags; grants never wait on the merge
        self.queues = [queue.Queue(maxsize=256) for _ in range(nproc)]
        self.t_spawn = time.time()
        try:
            for wk in range(nproc):
                self.procs.append(subprocess.Popen(
                    _worker_argv(_worker_spec(args, wk, level)),
                    stdout=subprocess.PIPE, stdin=subprocess.PIPE, env=env))
            self.readers = [threading.Thread(target=self._reader_main,
                                             args=(i,), daemon=True)
                            for i in range(nproc)]
            for t in self.readers:
                t.start()
        except BaseException:
            self.stop()
            raise

    def _grant_chunk(self, i):
        with self.grant_lock:
            start = self.next_start
            self.next_start += CHUNK
        try:
            self.procs[i].stdin.write(struct.pack("<qq", start, CHUNK))
            self.procs[i].stdin.flush()
        except (BrokenPipeError, OSError):
            pass   # the worker ended its stream; its E frame decides

    def _read_frame(self, i):
        """One L or E frame of worker i, answering R frames on the way;
        None at the end of its stream."""
        fh = self.procs[i].stdout
        while True:
            tag = _read_exact(fh, 1)
            if tag is None:
                raise RuntimeError(
                    f"genotype worker {i} exited without end-of-stream "
                    f"(rc={self.procs[i].wait()})")
            if tag == b"R":
                self._grant_chunk(i)
                continue
            if tag == b"E":
                self.stats[i] = struct.unpack("<QQ", _read_exact(fh, 16))
                return None
            if tag != b"L":
                raise RuntimeError(f"genotype worker {i}: bad frame tag "
                                   f"{tag!r}")
            j, vcf_len, n_bam = struct.unpack("<QII", _read_exact(fh, 16))
            vcf = _read_exact(fh, vcf_len)
            recs = []
            for _ in range(n_bam):
                rec_len, rid, pos, ref_end = struct.unpack(
                    "<Iiqq", _read_exact(fh, 24))
                recs.append((_read_exact(fh, rec_len), rid, pos, ref_end))
            return j, vcf, recs

    def _reader_main(self, i):
        try:
            while True:
                frame = self._read_frame(i)
                self.queues[i].put(frame)
                if frame is None:
                    return
        except Exception as e:   # raised on the merge thread
            self.failure.append(e)

    def _next_frame(self, i):
        while True:
            if self.failure:
                raise self.failure[0]
            try:
                return self.queues[i].get(timeout=0.1)
            except queue.Empty:
                continue

    def merge(self, vcf_writer, bam_writer):
        """Write every worker's records in catalog order; (loci written,
        catalog errors)."""
        try:
            heap = []
            for i in range(len(self.procs)):
                frame = self._next_frame(i)
                if frame is not None:
                    heapq.heappush(heap, (frame[0], i, frame[1], frame[2]))
            while heap:
                _, i, vcf, recs = heapq.heappop(heap)
                vcf_writer.write_bytes(vcf)
                if bam_writer is not None:
                    for rec, rid, pos, ref_end in recs:
                        bam_writer.write_encoded(rec, rid, pos, ref_end)
                frame = self._next_frame(i)
                if frame is not None:
                    heapq.heappush(heap, (frame[0], i, frame[1], frame[2]))
        except BaseException:
            self.stop()
            raise
        t_end = time.time()
        for t in self.readers:
            t.join()
        for i, p in enumerate(self.procs):
            rc = p.wait()
            p.stdin.close()
            p.stdout.close()
            if rc != 0:
                # stats[i] set: the end-of-stream frame arrived, so every
                # record was delivered; a nonzero exit after it is teardown
                if self.stats[i] is None:
                    raise RuntimeError(f"genotype worker {i} failed "
                                       f"(rc={rc})")
                log.warning("genotype worker %d exited rc=%d after "
                            "end-of-stream; outputs are complete", i, rc)
        # where a run's wall goes beside the workers' own ready and done
        log.debug("worker pool: %d workers spawned at %.3f (epoch); the last "
                  "end-of-stream %.3f s and the last exit %.3f s after",
                  len(self.procs), self.t_spawn, t_end - self.t_spawn,
                  time.time() - self.t_spawn)
        n_ok = sum(s[0] for s in self.stats if s)
        # every worker parses the whole catalog, so each counts every bad
        # catalog line: max() recovers the -t 1 count
        n_err = max((s[1] for s in self.stats if s), default=0)
        return n_ok, n_err

    def stop(self) -> None:
        """Kill every worker, let the readers see the ends of their pipes
        (draining their queues so that none blocks on a full one), and
        close the pipes."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
            try:
                p.stdin.close()
            except OSError:
                pass
        for t, q in zip(self.readers, self.queues):
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
        for p in self.procs:
            p.stdout.close()


def run_genotype(args) -> int:
    """Genotype `args.repeats_path` into `args.output_prefix`.vcf.gz (+
    .spanning.bam). Returns the number of loci written."""
    pool_run = use_pool(args)
    device = None if pool_run else resolve_device(args.device)
    karyotype = Karyotype.new(args.karyotype)
    genotyper = Genotyper.from_str(args.genotyper)
    scoring = TrgtScoring.from_string(args.aln_scoring)
    shard_index, shard_count = args.shard_index, args.shard_count
    if shard_count:
        if shard_index is None or not 0 <= shard_index < shard_count:
            raise ValueError("--shard-index must be in [0, --shard-count)")

    bam = open_alignments(args.reads_path, args.genome_path)
    if not bam.header.is_mapped():
        raise RuntimeError("Input BAM is not mapped")
    sample_name = args.sample_name or get_sample_name(args.reads_path,
                                                      bam.header)
    command_line = " ".join(sys.argv)
    output_flank_len = min(args.flank_len, args.output_flank_len)

    def open_writers():
        vcf_writer = VcfWriter(f"{args.output_prefix}.vcf.gz", sample_name,
                               bam.header.references, command_line,
                               FULL_VERSION, PROGRAM_NAME)
        if args.disable_bam_output:
            return vcf_writer, None
        header_text = bam.header.text
        if not header_text.endswith("\n") and header_text:
            header_text += "\n"
        header_text += (f"@PG\tID:{PROGRAM_NAME}\tPN:{PROGRAM_NAME}\t"
                        f"CL:{command_line}\tVN:{FULL_VERSION}\n")
        return vcf_writer, BamWriter(f"{args.output_prefix}.spanning.bam",
                                     header_text, bam.header.references)

    if pool_run:
        # spawned before the parent imports torch to check the device, so
        # that the workers' start-up runs beside the parent's
        pool = WorkerPool(args, args.num_threads)
        try:
            check_mode(args.device)
            vcf_writer, bam_writer = open_writers()
            try:
                n_ok, n_err = pool.merge(vcf_writer, bam_writer)
            finally:
                vcf_writer.close()
                if bam_writer is not None:
                    bam_writer.close()
        except BaseException:
            pool.stop()
            raise
        log.info("Processed %d loci (%d errors)", n_ok, n_err)
        return n_ok

    vcf_writer, bam_writer = open_writers()
    params = Params(
        min_flank_id_frac=args.min_flank_id_frac,
        min_read_qual=args.min_hifi_read_qual,
        search_flank_len=args.flank_len,
        max_depth=args.max_depth,
        aln_scoring=scoring,
    )

    from .. import mesh
    from .pipeline import STAGE_TIMES, _STAGE_LOCK, BatchPipeline, _timed
    if device is not None:
        mesh.auto_enable(device.type)
    genome = FastaReader(args.genome_path)
    n_err = 0

    def on_error(msg):
        nonlocal n_err
        log.error("Locus processing: %s", msg)
        n_err += 1

    on_cuda = device is not None and device.type == "cuda"
    pipeline = BatchPipeline(
        params, device,
        batch_size=args.batch_size or (256 if on_cuda else 64),
        num_threads=args.num_threads,
        bam_factory=lambda: open_alignments(args.reads_path,
                                            args.genome_path))
    loci = iter_loci(args.repeats_path, genome, karyotype, args.flank_len,
                     genotyper, on_error=on_error)
    if shard_count:
        loci = (locus for i, locus in enumerate(loci)
                if i % shard_count == shard_index)

    # writer thread: record building + BGZF deflate overlap the next
    # batch's compute; records stay in pipeline order
    write_queue: "queue.Queue" = queue.Queue(maxsize=4096)
    writer_error = []

    def writer_main():
        while True:
            item = write_queue.get()
            if item is None:
                return
            w_locus, w_results = item
            try:
                t_cpu = time.thread_time()
                with _timed("write"):
                    vcf_writer.write(w_locus, w_results)
                    if bam_writer is not None:
                        write_spanning_reads(bam_writer, w_locus, w_results,
                                             output_flank_len)
                with _STAGE_LOCK:
                    STAGE_TIMES["write_cpu"] += time.thread_time() - t_cpu
            except Exception as e:   # surfaced on the main thread
                writer_error.append(e)
                return

    writer_thread = threading.Thread(target=writer_main, daemon=True)
    writer_thread.start()

    def put_checked(item) -> bool:
        # a dead writer stops draining the bounded queue: re-check its
        # error between bounded attempts so it always surfaces
        while True:
            if writer_error:
                return False
            try:
                write_queue.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue

    n_ok = 0
    try:
        for locus, results in pipeline.process(loci, bam):
            if not put_checked((locus, results)):
                break
            n_ok += 1
    finally:
        put_checked(None)
        writer_thread.join()
    if writer_error:
        raise writer_error[0]
    vcf_writer.close()
    if bam_writer is not None:
        bam_writer.close()
    log.info("Processed %d loci (%d errors)", n_ok, n_err)
    return n_ok
