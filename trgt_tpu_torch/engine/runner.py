"""The port's `genotype` driver (counterpart of
`trgt_tpu/engine/runner.py:289 run_genotype`).

Stream loci → `TorchBatchPipeline` → VCF + spanning BAM through the JAX
package's JAX-free readers and writers, with the same writer thread. No
JAX and no device mesh: `--device` picks CUDA kernels, their plain
PyTorch versions on the CPU, or the host twins (device.py). `-t N`
threads read extraction inside the pipeline; the worker-process pool of
the JAX package is not ported yet.
"""

import logging
import queue
import sys
import threading
import time

from trgt_tpu import FULL_VERSION
from trgt_tpu.engine.pipeline import STAGE_TIMES, _STAGE_LOCK, _timed
from trgt_tpu.engine.runner import (PROGRAM_NAME, get_sample_name,
                                    open_alignments, write_spanning_reads)
from trgt_tpu.engine.workflow import Params
from trgt_tpu.io.bam_write import BamWriter
from trgt_tpu.io.catalog import iter_loci
from trgt_tpu.io.fasta import FastaReader
from trgt_tpu.io.vcf_write import VcfWriter
from trgt_tpu.utils import Genotyper, Karyotype, TrgtScoring

from ..device import resolve_device
from .pipeline import TorchBatchPipeline

log = logging.getLogger("trgt")


def run_genotype(args) -> int:
    """Genotype `args.repeats_path` into `args.output_prefix`.vcf.gz (+
    .spanning.bam). Returns the number of loci written."""
    device = resolve_device(args.device)
    karyotype = Karyotype.new(args.karyotype)
    genotyper = Genotyper.from_str(args.genotyper)
    scoring = TrgtScoring.from_string(args.aln_scoring)

    bam = open_alignments(args.reads_path, args.genome_path)
    if not bam.header.is_mapped():
        raise RuntimeError("Input BAM is not mapped")
    sample_name = args.sample_name or get_sample_name(args.reads_path,
                                                      bam.header)

    command_line = " ".join(sys.argv)
    vcf_writer = VcfWriter(f"{args.output_prefix}.vcf.gz", sample_name,
                           bam.header.references, command_line,
                           FULL_VERSION, PROGRAM_NAME)
    output_flank_len = min(args.flank_len, args.output_flank_len)
    bam_writer = None
    if not args.disable_bam_output:
        header_text = bam.header.text
        if not header_text.endswith("\n") and header_text:
            header_text += "\n"
        header_text += (f"@PG\tID:{PROGRAM_NAME}\tPN:{PROGRAM_NAME}\t"
                        f"CL:{command_line}\tVN:{FULL_VERSION}\n")
        bam_writer = BamWriter(f"{args.output_prefix}.spanning.bam",
                               header_text, bam.header.references)

    params = Params(
        min_flank_id_frac=args.min_flank_id_frac,
        min_read_qual=args.min_hifi_read_qual,
        search_flank_len=args.flank_len,
        max_depth=args.max_depth,
        aln_scoring=scoring,
    )
    shard_index, shard_count = args.shard_index, args.shard_count
    if shard_count:
        if shard_index is None or not 0 <= shard_index < shard_count:
            raise ValueError("--shard-index must be in [0, --shard-count)")

    genome = FastaReader(args.genome_path)
    n_err = 0

    def on_error(msg):
        nonlocal n_err
        log.error("Locus processing: %s", msg)
        n_err += 1

    on_cuda = device is not None and device.type == "cuda"
    pipeline = TorchBatchPipeline(
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
