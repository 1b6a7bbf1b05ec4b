"""Per-locus analysis workflow (ref: src/trgt/workflows/tr.rs).

Host orchestration: extract reads → clip → locate spans → genotype →
HMM-annotate → methylation. The heavy DP steps (span location, distance
matrices, Viterbi) can be routed through batched device kernels by the
engine (engine/batch.py); this module contains the exact per-locus
decision logic."""

import logging
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..genotype import (find_tr_spans, genotype_cluster, genotype_flank,
                        genotype_size)
from ..genotype.gt import Gt, TrSize
from ..hmm import (Annotation, build_hmm, calc_purity, collapse_labels,
                   count_motifs, label_motifs, remove_imperfect_motifs,
                   replace_invalid_bases)
from ..reads import HiFiRead, clip_to_region
from ..utils import Genotyper, Ploidy, TrgtScoring
from ..utils.rand_rs import StdRng

log = logging.getLogger("trgt")

# HMM topologies repeat across loci (same motif sets) — cache them so the
# device transition tables are built and uploaded once per topology.
_HMM_CACHE = {}


def cached_hmm(motifs):
    key = tuple(motifs)
    hmm = _HMM_CACHE.get(key)
    if hmm is None:
        if len(_HMM_CACHE) > 512:
            _HMM_CACHE.clear()
        hmm = build_hmm(list(motifs))
        _HMM_CACHE[key] = hmm
    return hmm


@dataclass
class Params:
    min_flank_id_frac: float
    min_read_qual: float
    search_flank_len: int
    max_depth: int
    aln_scoring: TrgtScoring = field(
        default_factory=lambda: TrgtScoring(2, 5, 1))


@dataclass
class Allele:
    seq: str
    annotation: Annotation
    ci: Tuple[int, int]
    num_spanning: int
    meth: Optional[float]


@dataclass
class LocusResult:
    genotype: List[Allele]
    reads: List[HiFiRead]
    tr_spans: List[Tuple[int, int]]
    classification: List[int]

    @classmethod
    def empty(cls):
        return cls([], [], [], [])


class StdRngReservoir:
    """Reservoir-sampling RNG, bit-identical to the reference's
    StdRng::seed_from_u64(42) + random_range (tr.rs:312-338): rand 0.9's
    ChaCha12 StdRng with Canon's-method uniform sampling, reimplemented
    in utils/rand_rs.py (validated against rand's own value-stability
    vectors). A >3x-max-depth locus therefore selects the identical read
    subset the reference selects."""

    def __init__(self, seed: int = 42):
        self._rng = StdRng.seed_from_u64(seed)

    def range(self, n: int) -> int:
        return self._rng.random_range(n)


def analyze_tr(locus, params: Params, bam, engine=None) -> LocusResult:
    # ref: tr.rs:24-109
    if locus.ploidy == Ploidy.ZERO:
        return LocusResult.empty()
    reads = extract_and_clip_reads(locus, bam, params)
    log.debug("%s: %d reads left after clipping", locus.id, len(reads))

    reads, spans = get_spanning_reads(locus, params, reads, engine)

    MIN_RQ_FOR_PURITY = 0.9
    if params.min_read_qual < MIN_RQ_FOR_PURITY:
        new_reads, new_spans = filter_impure_trs(locus, reads, spans,
                                                 MIN_RQ_FOR_PURITY, engine)
        if len(new_reads) < len(reads):
            log.warning("%s: Filtered out %d impure reads", locus.id,
                        len(reads) - len(new_reads))
        reads, spans = new_reads, new_spans

    if not reads:
        return LocusResult.empty()

    trs = [read.bases[s[0]:s[1]].decode() for read, s in zip(reads, spans)]

    if locus.genotyper == Genotyper.SIZE:
        gt, allele_seqs, classification = genotype_size.genotype(
            locus.ploidy, trs)
    else:
        pair_dists = (engine.pair_distances([t.encode() for t in trs])
                      if engine is not None else None)
        gt, allele_seqs, classification = genotype_cluster.genotype(
            locus.ploidy, trs, pair_dists=pair_dists)

    # SNP-flank re-genotype rescue when allele sizes are close (tr.rs:70-75)
    if len(gt) == 2 and abs(gt[0].size - gt[1].size) <= 10:
        snp_result = genotype_flank.genotype(reads, trs)
        if snp_result is not None:
            gt, allele_seqs, classification = snp_result

    annotations = label_with_hmm(locus, allele_seqs, engine)

    spanning_by_hap = [sum(1 for x in classification if x == 0),
                       sum(1 for x in classification if x == 1)]
    meth_by_hap = get_meth(gt, reads, spans)
    genotype: List[Allele] = []
    for allele_index in range(len(gt)):
        genotype.append(Allele(
            seq=allele_seqs[allele_index],
            annotation=annotations[allele_index],
            ci=gt[allele_index].ci,
            num_spanning=spanning_by_hap[allele_index],
            meth=meth_by_hap[allele_index],
        ))

    # Put reference allele first (tr.rs:96-101)
    if len(genotype) != 1 and genotype[0].seq != locus.tr \
            and genotype[1].seq == locus.tr:
        genotype[0], genotype[1] = genotype[1], genotype[0]
        classification = [1 - c for c in classification]

    return LocusResult(genotype, reads, spans, classification)


def extract_and_clip_reads(locus, bam, params: Params) -> List[HiFiRead]:
    """Fused extract+clip: native C++ fast path when available (one pass
    over the BAI chunk: filter, decode, MM/ML meth, SNP offsets, clip),
    else the Python twin below."""
    import os
    clip_radius = 2 * params.search_flank_len
    if os.environ.get("TRGT_NATIVE_EXTRACT", "1") != "0":
        from ..reads.native_extract import (extract_and_clip_native,
                                            native_extract_available)
        if native_extract_available(bam):
            reads = extract_and_clip_native(locus, bam, params, clip_radius)
            if reads is not None:
                return reads
    reads = extract_reads(locus, bam, params)
    return clip_reads(locus, clip_radius, reads)


def extract_reads(locus, bam, params: Params) -> List[HiFiRead]:
    # ref: tr.rs:268-361
    flank_len = params.search_flank_len
    reservoir_threshold = params.max_depth * 3
    beg = max(0, locus.region.start - flank_len)
    end = locus.region.end + flank_len

    reads: List[HiFiRead] = []
    n_filt = 0
    n_reads = 0
    rng = None
    for rec in bam.fetch(locus.region.contig, beg, end):
        if rec.is_supplementary or rec.is_secondary:
            continue
        rq = rec.get_tag("rq")
        rq_val = float(rq) if isinstance(rq, float) else 1.0
        if rq_val < params.min_read_qual:
            n_filt += 1
            continue
        if n_reads < reservoir_threshold:
            reads.append(HiFiRead.from_bam_rec(rec, locus.region))
        else:
            if rng is None:
                log.warning("%s: Reservoir sampling reads", locus.id)
                rng = StdRngReservoir(42)
            j = rng.range(n_reads)
            if j < reservoir_threshold:
                reads[j] = HiFiRead.from_bam_rec(rec, locus.region)
        n_reads += 1

    if n_filt > 0:
        log.warning("%s: Quality filtered %d/%d reads", locus.id, n_filt,
                    n_filt + n_reads)
    return reads


def clip_reads(locus, radius: int, reads: List[HiFiRead]) -> List[HiFiRead]:
    # ref: tr.rs:186-196
    region = (locus.region.start - radius, locus.region.end + radius)
    out = []
    for read in reads:
        clipped = clip_to_region(read, region)
        if clipped is not None:
            out.append(clipped)
    return out


def get_spanning_reads(locus, params: Params, reads: List[HiFiRead],
                       engine=None):
    # ref: tr.rs:111-170
    batch_aligner = engine.batch_flank_aligner if engine is not None else None
    tr_spans = find_tr_spans(
        locus.left_flank.encode(), locus.right_flank.encode(),
        [r.bases for r in reads], params.search_flank_len,
        params.min_flank_id_frac, params.aln_scoring,
        batch_aligner=batch_aligner)

    reads_and_spans = [(r, s) for r, s in zip(reads, tr_spans)
                       if s is not None]
    log.debug("%s: Found %d spanning reads", locus.id, len(reads_and_spans))
    if not reads_and_spans:
        return [], []

    reads_and_spans = [
        (r, s) for r, s in reads_and_spans
        if s[0] >= params.search_flank_len
        and len(r.bases) - s[1] >= params.search_flank_len]
    log.debug("%s: %d spanning reads had sufficiently long flanks",
              locus.id, len(reads_and_spans))
    if not reads_and_spans:
        return [], []

    reads_and_spans.sort(key=lambda rs: rs[1][1] - rs[1][0])
    if len(reads_and_spans) > params.max_depth:
        reads_and_spans = uniform_downsample(reads_and_spans,
                                             params.max_depth)
        log.debug("%s: downsampled to %d reads", locus.id,
                  len(reads_and_spans))

    reads = [r for r, _ in reads_and_spans]
    spans = [s for _, s in reads_and_spans]
    return reads, spans


def uniform_downsample(reads_and_spans, output_length: int):
    # ref: tr.rs:172-184 — in-place swap walk with fractional stride
    items = list(reads_and_spans)
    num_reads = float(len(items))
    fast = 0.0
    step = num_reads / output_length
    for i in range(output_length):
        ind = int(fast)
        if ind != i:
            items[i], items[ind] = items[ind], items[i]
        fast += step
    return items[:output_length]


def filter_impure_trs(locus, reads, spans, rq_cutoff: float,
                      engine=None):
    # ref: tr.rs:400-452
    if not reads:
        return reads, spans
    max_filter = max(1, round(0.1 * len(reads)))
    PURITY_CUTOFF = 0.9
    hmm = None
    motifs = None
    scored = []
    for read, span in zip(reads, spans):
        if read.read_qual is not None and read.read_qual >= rq_cutoff:
            scored.append((read, span, 1.0))
            continue
        if hmm is None:
            motifs = [replace_invalid_bases(m, "ATCGN").encode()
                      for m in locus.motifs]
            hmm = cached_hmm(motifs)
        seq = read.bases[span[0]:span[1]].decode()
        seq = replace_invalid_bases(seq, "ATCG")
        scored.append((read, span, seq))

    # batch all low-rq labelings through the device engine
    pending = [(i, t[2]) for i, t in enumerate(scored)
               if isinstance(t[2], str)]
    if pending:
        queries = [q for _, q in pending]
        if engine is not None:
            paths = engine.viterbi(hmm, queries)
        else:
            paths = [hmm.label(q) for q in queries]
        for (i, q), labels in zip(pending, paths):
            read, span, _ = scored[i]
            purity = calc_purity(q.encode(), hmm, motifs, labels)
            scored[i] = (read, span, purity)

    # f64::total_cmp semantics: NaN purity sorts last
    scored.sort(key=lambda t: (math.isnan(t[2]),
                               0.0 if math.isnan(t[2]) else t[2]))
    num_filtered = 0
    kept = []
    for read, span, purity in scored:
        if purity >= PURITY_CUTOFF or num_filtered >= max_filter:
            kept.append((read, span))
        else:
            num_filtered += 1
    return [r for r, _ in kept], [s for _, s in kept]


def label_with_hmm(locus, seqs: List[str], engine=None) -> List[Annotation]:
    # ref: tr.rs:454-492
    motifs = [replace_invalid_bases(m, "ATCGN").encode()
              for m in locus.motifs]
    hmm = cached_hmm(motifs)
    cleaned = [replace_invalid_bases(s, "ATCG") for s in seqs]
    if engine is not None:
        paths = engine.viterbi(hmm, cleaned)
    else:
        paths = [hmm.label(s) for s in cleaned]
    annotations = []
    for seq, labels in zip(cleaned, paths):
        purity = calc_purity(seq.encode(), hmm, motifs, labels)
        labels = remove_imperfect_motifs(hmm, motifs, labels, seq.encode(), 6)
        spans = label_motifs(hmm, labels)
        spans = [s for s in spans if s.motif_index < len(motifs)]
        motif_counts = count_motifs(locus.motifs, spans)
        spans = collapse_labels(spans)
        annotations.append(Annotation(
            labels=spans if spans else None,
            motif_counts=motif_counts,
            purity=purity,
        ))
    return annotations


def get_meth(gt: Gt, reads, spans) -> List[Optional[float]]:
    # ref: tr.rs:198-266
    meths_1: List[float] = []
    meths_2: List[float] = []
    for read, span in zip(reads, spans):
        if read.meth is None:
            continue
        level = get_tr_meth(read, span)
        if level is None:
            continue
        assignment = assign_read(gt, span[1] - span[0])
        if assignment == "first":
            meths_1.append(level)
        elif assignment == "second":
            meths_2.append(level)
        elif assignment == "both":
            meths_1.append(level)
            meths_2.append(level)

    meth_1 = sum(meths_1) / len(meths_1) if meths_1 else None
    meth_2 = sum(meths_2) / len(meths_2) if meths_2 else None
    if len(gt) == 2:
        return [meth_1, meth_2]
    return [meth_1]


def assign_read(gt: Gt, tr_len: int) -> str:
    # ref: tr.rs:239-266
    if len(gt) == 1:
        return "first"
    hap1_len, hap2_len = gt[0].size, gt[1].size
    spans_1 = gt[0].ci[0] <= tr_len <= gt[0].ci[1]
    spans_2 = gt[1].ci[0] <= tr_len <= gt[1].ci[1]
    dist_1 = abs(tr_len - hap1_len)
    dist_2 = abs(tr_len - hap2_len)
    if dist_1 < dist_2 and spans_1:
        return "first"
    if dist_2 < dist_1 and spans_2:
        return "second"
    if hap1_len == hap2_len and spans_1:
        return "both"
    return "none"


def get_tr_meth(read: HiFiRead, span) -> Optional[float]:
    # ref: tr.rs:363-398
    if read.meth is None or len(read.meth) == 0:
        return None
    meth = read.meth
    total_meth = 0.0
    cpg_count = 0
    cpg_index = 0
    for pos in range(len(read.bases) - 1):
        if read.bases[pos:pos + 2] == b"CG":
            if span[0] <= pos < span[1]:
                cpg_count += 1
                if cpg_index >= len(meth):
                    raise ValueError(
                        f"Read {read.id} has malformed methylation profile")
                total_meth += meth[cpg_index] / 255.0
            cpg_index += 1
    if cpg_count != 0:
        return total_meth / cpg_count
    return None
