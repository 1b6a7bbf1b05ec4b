"""The port's `genotype` driver (counterpart of
`trgt_tpu/engine/runner.py:289 run_genotype`).

Stream loci → `BatchPipeline` → VCF + spanning BAM through the port's
own readers and writers, with a writer thread. No device mesh:
`--device` picks CUDA kernels, their plain PyTorch versions on the CPU,
or the host twins (device.py). `-t N` threads read extraction inside the
pipeline; the worker-process pool of the JAX package is not ported yet.
"""

import logging
import os
import queue
import sys
import threading
import time
from typing import Optional

from .. import FULL_VERSION
from ..device import resolve_device
from ..io.bam import BamReader
from ..io.bam_write import BamWriter, build_record, encode_bamlet_record
from ..io.catalog import iter_loci
from ..io.fasta import FastaReader
from ..io.vcf_write import VcfWriter
from ..reads import clip_bases
from ..utils import Genotyper, Karyotype, TrgtScoring
from .pipeline import STAGE_TIMES, _STAGE_LOCK, BatchPipeline, _timed
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
