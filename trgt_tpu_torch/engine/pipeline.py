"""Cross-locus batched pipeline of the PyTorch port (counterpart of
`trgt_tpu/engine/pipeline.py`).

Loci are processed in batches; each per-locus decision stays host-side
(workflow.py), while the hot DP stages are hoisted into one batched call
per stage:

  spans          ALL (read x flank) alignment misses across the batch →
                 `kernels.semiglobal.flank_align_batch_multi`
  impure filter  ALL Viterbi labelings of low-quality reads (targeted
  and annotate   preset) and of the alleles → `kernels.viterbi.
                 viterbi_batch_multi`
  genotype       ALL small edit-distance pairs of the cluster loci →
                 `kernels.editdist.edit_distances_batch`; consensus
                 repair of every genotyper → `kernels.e2e.e2e_align_batch`

Every stage has two explicit branches. With `device=None` (`--device
host`) it runs the host twin (`align_host`, `native`, `Hmm.label`); with
a torch device it runs the port's kernel module, which launches the CUDA
kernel for a GPU and its plain PyTorch version for the CPU. There is no
race between the two, no latch, and nothing catches a failing kernel.
"""

import contextlib
import logging
import math
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..genotype import consensus, genotype_cluster, genotype_flank, \
    genotype_size
from ..hmm import (Annotation, collapse_labels, count_motifs,
                   replace_invalid_bases)
# numpy-vectorized decoders, equal to the decode.py replicas
from ..hmm.decode_fast import (fast_calc_purity as calc_purity,
                               fast_label_motifs as label_motifs,
                               fast_remove_imperfect_motifs as
                               remove_imperfect_motifs)
from ..io import native
from ..kernels import span_window
from ..kernels.align_host import (align_end_to_end, align_ends_free_text,
                                  edit_distance)
from ..kernels.e2e import e2e_align_batch
from ..kernels.editdist import MAX_OPS, edit_distances_batch
from ..kernels.semiglobal import flank_align_batch_multi
from ..kernels.viterbi import viterbi_batch_multi
from ..utils import Genotyper, Ploidy
from .workflow import (Allele, LocusResult, Params, cached_hmm,
                       extract_and_clip_reads, get_meth, uniform_downsample)

log = logging.getLogger("trgt")

MIN_RQ_FOR_PURITY = 0.9
PURITY_CUTOFF = 0.9

# cumulative wall-clock per pipeline stage (seconds); `extract` runs in
# the prefetch thread and `write` in the writer thread, both overlapping
# the other stages, so the stage times sum to MORE than end-to-end wall
# time. The lock makes the += safe across those threads.
STAGE_TIMES: Counter = Counter()
_STAGE_LOCK = threading.Lock()


@contextlib.contextmanager
def _timed(stage: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _STAGE_LOCK:
            STAGE_TIMES[stage] += dt


class _LocusState:
    __slots__ = ("locus", "reads", "spans", "trs", "result", "done",
                 "gt", "allele_seqs", "classification", "hmm", "motifs",
                 "annotations")

    def __init__(self, locus):
        self.locus = locus
        self.reads = []
        self.spans = []
        self.trs = []
        self.result = None
        self.done = False
        self.gt = None
        self.allele_seqs = None
        self.classification = None
        self.hmm = None
        self.motifs = None


class BatchPipeline:
    def __init__(self, params: Params, device: Optional[torch.device],
                 batch_size: int = 64, num_threads: int = 1,
                 bam_factory=None):
        self.params = params
        # None = the host twins; else the device of the port's kernels
        self.device = device
        self.batch_size = batch_size
        self.num_threads = max(1, num_threads)
        # per-thread BAM readers (the reference's thread-local readers,
        # ref commands/genotype.rs:35-64); BGZF inflate releases the GIL
        self.bam_factory = bam_factory
        self._tls = None
        if bam_factory is not None and self.num_threads > 1:
            self._tls = threading.local()

    def _thread_bam(self, default_bam):
        if self._tls is None:
            return default_bam
        bam = getattr(self._tls, "bam", None)
        if bam is None:
            bam = self.bam_factory()
            self._tls.bam = bam
        return bam

    def process(self, loci, bam):
        """Yields (locus, LocusResult) in input order, batch by batch.

        Host read extraction of batch N+1 overlaps the compute of batch
        N (double buffering)."""
        def batches():
            batch: List = []
            for locus in loci:
                batch.append(locus)
                if len(batch) >= self.batch_size:
                    yield batch
                    batch = []
            if batch:
                yield batch

        with ThreadPoolExecutor(1) as prefetch:
            prev = None
            for batch in batches():
                fut = prefetch.submit(self._extract_batch, batch, bam)
                if prev is not None:
                    yield from self._finish_batch(prev.result())
                prev = fut
            if prev is not None:
                yield from self._finish_batch(prev.result())

    # ---- per-batch stages ----
    def _extract_batch(self, loci, bam):
        with _timed("extract"):
            return self._extract_batch_inner(loci, bam)

    def _extract_batch_inner(self, loci, bam):
        params = self.params
        states = []
        pending = []
        for locus in loci:
            st = _LocusState(locus)
            states.append(st)
            if locus.ploidy == Ploidy.ZERO:
                st.result = LocusResult.empty()
                st.done = True
                continue
            pending.append(st)

        def extract_one(st):
            reader = self._thread_bam(bam)
            st.reads = extract_and_clip_reads(st.locus, reader, params)

        if self.num_threads > 1 and len(pending) > 1:
            with ThreadPoolExecutor(self.num_threads) as pool:
                list(pool.map(extract_one, pending))
        else:
            for st in pending:
                extract_one(st)
        return states

    def _finish_batch(self, states):
        with _timed("spans"):
            self._stage_spans(states)
        with _timed("impure_filter"):
            self._stage_impure_filter(states)
        with _timed("genotype"):
            self._stage_genotype(states)
        with _timed("annotate"):
            self._stage_annotate(states)

        with _timed("assemble"):
            for st in states:
                if st.result is None:
                    st.result = self._assemble(st)
        for st in states:
            yield st.locus, st.result

    # ---- stage 1: span location ----
    def _stage_spans(self, states):
        params = self.params
        fl = params.search_flank_len
        miss: List[Tuple[int, int, int]] = []      # (state_i, read_i, which)
        miss_patterns: List[bytes] = []
        miss_texts: List[bytes] = []
        span_grids = []                             # per state: 2 lists
        for si, st in enumerate(states):
            if st.done:
                span_grids.append(None)
                continue
            lf_piece = st.locus.left_flank.encode()[-fl:]
            rf_piece = st.locus.right_flank.encode()[:fl]
            lf_spans = [None] * len(st.reads)
            rf_spans = [None] * len(st.reads)
            for which, piece, spans in ((0, lf_piece, lf_spans),
                                        (1, rf_piece, rf_spans)):
                for ri, read in enumerate(st.reads):
                    # a read shorter than 2×flank can never pass the
                    # spanning filter below (s[0] ≥ fl ∧ len−s[1] ≥ fl
                    # ⇒ len ≥ 2·fl), so skip its alignments outright —
                    # the locus window ± flank drags in neighbouring
                    # reads that only partially overlap (the reference
                    # pays the WFA cost and discards them afterwards,
                    # tr.rs:111-170; the outcome is identical)
                    if len(read.bases) < 2 * fl:
                        continue
                    start = read.bases.find(piece)
                    if start != -1:
                        spans[ri] = (start, start + len(piece))
                    else:
                        miss.append((si, ri, which))
                        miss_patterns.append(piece)
                        miss_texts.append(read.bases)
            span_grids.append((lf_spans, rf_spans))

        if miss:
            threshold = fl * params.min_flank_id_frac
            sc = params.aln_scoring
            results = self._align_misses(miss_patterns, miss_texts, sc)
            for (si, ri, which), (score, matches, span) in zip(miss,
                                                               results):
                if float(matches) >= threshold:
                    span_grids[si][which][ri] = span

        for st, grids in zip(states, span_grids):
            if st.done:
                continue
            lf_spans, rf_spans = grids
            spans = []
            for lf_span, rf_span in zip(lf_spans, rf_spans):
                if lf_span is None or rf_span is None:
                    spans.append(None)
                elif lf_span[1] <= rf_span[0]:
                    spans.append((lf_span[1], rf_span[0]))
                else:
                    spans.append(None)
            self._finish_spans(st, spans)


    def _align_misses(self, patterns, texts, sc):
        # certified seed-window banding (kernels/span_window.py): shrink
        # the text axis of every miss to the windows that provably
        # contain all optimal alignments, align the windows, and
        # recompute the rare certificate failures on the full text:
        # bit-identical results at a fraction of the cells
        plans = [span_window.plan_windows(p, t, sc.mism_scr, sc.gapo_scr,
                                          sc.gape_scr)
                 for p, t in zip(patterns, texts)]
        sub_patterns, sub_texts, sub_bands, owners = span_window.expand(
            plans, patterns, texts)
        if self.device is None:
            sub_results = self._host_align_windows(sub_patterns, sub_texts,
                                                   sub_bands, sc)
        else:
            sub_results = flank_align_batch_multi(
                sub_patterns, sub_texts, sc.mism_scr, sc.gapo_scr,
                sc.gape_scr, self.device)
        out, redo = span_window.reduce_and_certify(
            plans, owners, sub_results, len(texts), sc.mism_scr,
            sc.gapo_scr, sc.gape_scr)
        if redo:
            log.debug("span windows: %d/%d certificate failures "
                      "recomputed on the full text", len(redo),
                      len(texts))
            if self.device is None:
                full = []
                for mi in redo:
                    score, matches, _, tspan = align_ends_free_text(
                        patterns[mi], texts[mi], sc.mism_scr, sc.gapo_scr,
                        sc.gape_scr)
                    full.append((score, matches, tspan))
            else:
                full = flank_align_batch_multi(
                    [patterns[mi] for mi in redo],
                    [texts[mi] for mi in redo], sc.mism_scr, sc.gapo_scr,
                    sc.gape_scr, self.device)
            for mi, res in zip(redo, full):
                out[mi] = res
        return out

    def _host_align_windows(self, sub_patterns, sub_texts, sub_bands, sc):
        def one(ptb):
            p, t, band = ptb
            if band is not None:
                # diagonal-banded native DP, O(P*W) cells; the band is a
                # subset of the kernel's window, and the certificate
                # reduction makes both accept identical results
                # (span_window docstring)
                res = native.endsfree_banded(
                    p, t, sc.mism_scr, sc.gapo_scr, sc.gape_scr,
                    band[0], band[1])
                if res is not None:
                    score, matches, _, tspan = res
                    return (score, matches, tspan)
            score, matches, _, tspan = align_ends_free_text(
                p, t, sc.mism_scr, sc.gapo_scr, sc.gape_scr)
            return (score, matches, tspan)

        items = list(zip(sub_patterns, sub_texts, sub_bands))
        # the native DP releases the GIL, so threads speed the host span
        # twin (the reference's per-read rayon par_iter, span_locater.rs:8)
        if self.num_threads > 1 and len(items) > 8:
            with ThreadPoolExecutor(self.num_threads) as pool:
                return list(pool.map(one, items))
        return [one(it) for it in items]

    def _finish_spans(self, st, spans):
        # ref: tr.rs:111-170 (filters, sort by TR length, downsample)
        params = self.params
        rs = [(r, s) for r, s in zip(st.reads, spans) if s is not None]
        rs = [(r, s) for r, s in rs
              if s[0] >= params.search_flank_len
              and len(r.bases) - s[1] >= params.search_flank_len]
        if not rs:
            st.reads, st.spans = [], []
            return
        rs.sort(key=lambda t: t[1][1] - t[1][0])
        if len(rs) > params.max_depth:
            rs = uniform_downsample(rs, params.max_depth)
        st.reads = [r for r, _ in rs]
        st.spans = [s for _, s in rs]

    # ---- stage 2a: impure-read filter (targeted preset) ----
    def _stage_impure_filter(self, states):
        params = self.params
        if params.min_read_qual >= MIN_RQ_FOR_PURITY:
            return
        # collect labelings for low-rq reads across the whole batch
        requests = []   # (state, read_i, hmm, motifs, seq)
        for st in states:
            if st.done or not st.reads:
                continue
            for ri, (read, span) in enumerate(zip(st.reads, st.spans)):
                if read.read_qual is not None and \
                        read.read_qual >= MIN_RQ_FOR_PURITY:
                    continue
                motifs = tuple(replace_invalid_bases(m, "ATCGN").encode()
                               for m in st.locus.motifs)
                hmm = cached_hmm(motifs)
                seq = read.bases[span[0]:span[1]].decode()
                seq = replace_invalid_bases(seq, "ATCG")
                requests.append((st, ri, hmm, list(motifs), seq))
        purities: Dict[Tuple[int, int], float] = {}
        if requests:
            paths = self._viterbi([r[2] for r in requests],
                                  [r[4] for r in requests])
            for (st, ri, hmm, motifs, seq), labels in zip(requests, paths):
                purities[(id(st), ri)] = calc_purity(
                    seq.encode(), hmm, motifs, labels)

        for st in states:
            if st.done or not st.reads:
                continue
            scored = []
            for ri, (read, span) in enumerate(zip(st.reads, st.spans)):
                p = purities.get((id(st), ri), 1.0)
                scored.append((read, span, p))
            max_filter = max(1, round(0.1 * len(scored)))
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
            if num_filtered:
                log.warning("%s: Filtered out %d impure reads",
                            st.locus.id, num_filtered)
            st.reads = [r for r, _ in kept]
            st.spans = [s for _, s in kept]

    # ---- stage 3: genotyping ----
    def _stage_genotype(self, states):
        # batch the cluster edit distances across loci, DEDUPLICATED:
        # edit distance is a pure function of the sequence pair, so
        # identical TR strings (common at depth: error-free reads of
        # the same allele) share one problem. Pair enumeration is
        # row-vectorized (no O(n²) Python loop).
        cluster_states = []
        all_pairs = []
        for st in states:
            if st.done:
                continue
            if not st.reads:
                st.result = LocusResult.empty()
                st.done = True
                continue
            st.trs = [read.bases[s[0]:s[1]].decode()
                      for read, s in zip(st.reads, st.spans)]
            if st.locus.genotyper == Genotyper.CLUSTER:
                uniq: Dict[bytes, int] = {}
                uidx = np.array([uniq.setdefault(t.encode(), len(uniq))
                                 for t in st.trs], dtype=np.int64)
                useqs = list(uniq)
                ulens = np.array([len(s) for s in useqs], dtype=np.int64)
                U = len(useqs)
                # |len diff| bound everywhere; exact ED overwrites the
                # small-product pairs below (ref genotype_cluster.rs:
                # 231-247 skip-bound semantics)
                ed_u = np.abs(ulens[:, None] - ulens[None, :]) \
                    .astype(np.float64)
                ei_parts, ej_parts = [], []
                for i in range(U - 1):
                    js = np.nonzero(
                        ulens[i] * ulens[i + 1:] <= MAX_OPS)[0]
                    if js.size:
                        ei_parts.append(np.full(js.size, i,
                                                dtype=np.int64))
                        ej_parts.append(js.astype(np.int64) + i + 1)
                if ei_parts:
                    ei = np.concatenate(ei_parts)
                    ej = np.concatenate(ej_parts)
                else:
                    ei = ej = np.empty(0, dtype=np.int64)
                start = len(all_pairs)
                all_pairs.extend((useqs[a], useqs[b])
                                 for a, b in zip(ei, ej))
                cluster_states.append((st, ed_u, uidx, ei, ej, start))

        pair_eds: List[int] = []
        if all_pairs:
            if self.device is None:
                pair_eds = [edit_distance(a, b) for a, b in all_pairs]
            else:
                pair_eds = edit_distances_batch(all_pairs, self.device)

        cluster_lookup = {}
        for st, ed_u, uidx, ei, ej, start in cluster_states:
            if ei.size:
                eds = np.asarray(pair_eds[start:start + ei.size],
                                 dtype=np.float64)
                ed_u[ei, ej] = eds
                ed_u[ej, ei] = eds
            cluster_lookup[id(st)] = (ed_u, uidx)

        aligner = self._consensus_aligner()
        for st in states:
            if st.done:
                continue
            if st.locus.genotyper == Genotyper.SIZE:
                gt, alleles, classification = genotype_size.genotype(
                    st.locus.ploidy, st.trs, aligner=aligner)
            else:
                gt, alleles, classification = genotype_cluster.genotype(
                    st.locus.ploidy, st.trs,
                    pair_dists=cluster_lookup.get(id(st)),
                    aligner=aligner)
            # SNP-flank rescue (tr.rs:70-75)
            if len(gt) == 2 and abs(gt[0].size - gt[1].size) <= 10:
                snp_result = genotype_flank.genotype(st.reads, st.trs,
                                                     aligner=aligner)
                if snp_result is not None:
                    gt, alleles, classification = snp_result
            st.gt = gt
            st.allele_seqs = alleles
            st.classification = classification

    # ---- stage 4: allele annotation ----
    def _stage_annotate(self, states):
        requests = []   # (state, allele_i, hmm, motifs, seq)
        for st in states:
            if st.done:
                continue
            motifs = tuple(replace_invalid_bases(m, "ATCGN").encode()
                           for m in st.locus.motifs)
            st.motifs = list(motifs)
            st.hmm = cached_hmm(motifs)
            for ai, seq in enumerate(st.allele_seqs):
                seq = replace_invalid_bases(seq, "ATCG")
                requests.append((st, ai, seq))
        if not requests:
            return
        paths = self._viterbi([r[0].hmm for r in requests],
                              [r[2] for r in requests])
        annos: Dict[Tuple[int, int], Annotation] = {}
        for (st, ai, seq), labels in zip(requests, paths):
            hmm, motifs = st.hmm, st.motifs
            purity = calc_purity(seq.encode(), hmm, motifs, labels)
            labels = remove_imperfect_motifs(hmm, motifs, labels,
                                             seq.encode(), 6)
            spans = label_motifs(hmm, labels)
            spans = [s for s in spans if s.motif_index < len(motifs)]
            motif_counts = count_motifs(st.locus.motifs, spans)
            spans = collapse_labels(spans)
            annos[(id(st), ai)] = Annotation(
                labels=spans if spans else None,
                motif_counts=motif_counts, purity=purity)
        for st in states:
            if st.done:
                continue
            st.annotations = [annos[(id(st), ai)]
                              for ai in range(len(st.allele_seqs))]


    def _consensus_aligner(self):
        """Consensus-repair aligner (ref: utils/align.rs affine 2,5,1),
        deduplicated: alignment is a pure function of the pair, and deep
        loci repeat identical read strings. On a device every distinct
        (backbone, read) pair of a call goes to the port's e2e module in
        one batch; CIGAR equality with the host aligner is
        fuzz-enforced (tests/test_torch_e2e.py)."""
        if self.device is None:
            if self.num_threads <= 1:
                return consensus.align_batch
            return self._host_consensus_aligner()
        device = self.device

        def device_aligner(backbone, seqs, scoring=(2, 5, 1)):
            mism, gapo, gape = scoring
            uniq = list(dict.fromkeys(seqs))
            res = e2e_align_batch(
                [(backbone.encode(), s.encode()) for s in uniq],
                mism, gapo, gape, device)
            by_seq = {s: cigar for s, (_score, cigar) in zip(uniq, res)}
            return [by_seq[s] for s in seqs]

        return device_aligner

    def _host_consensus_aligner(self):
        """Deduplicated, threaded host consensus aligner (the native DP
        releases the GIL, like the reference's utils/align.rs par_iter)."""
        def aligner(backbone, seqs, scoring=(2, 5, 1)):
            mism, gapo, gape = scoring
            bb = backbone.encode()
            uniq = list(dict.fromkeys(seqs))
            one = lambda s: align_end_to_end(bb, s.encode(), mism, gapo,
                                             gape)[1]
            if self.num_threads > 1 and len(uniq) > 4:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    cigs = list(pool.map(one, uniq))
            else:
                cigs = [one(s) for s in uniq]
            by_seq = dict(zip(uniq, cigs))
            return [by_seq[s] for s in seqs]

        return aligner

    def _viterbi(self, hmms, queries):
        if self.device is None:
            return [h.label(q) for h, q in zip(hmms, queries)]
        return viterbi_batch_multi(hmms, queries, self.device)

    # ---- assembly (tr.rs:79-108) ----
    def _assemble(self, st) -> LocusResult:
        gt = st.gt
        classification = st.classification
        spanning_by_hap = [sum(1 for x in classification if x == 0),
                           sum(1 for x in classification if x == 1)]
        meth_by_hap = get_meth(gt, st.reads, st.spans)
        genotype: List[Allele] = []
        for ai in range(len(gt)):
            genotype.append(Allele(
                seq=st.allele_seqs[ai],
                annotation=st.annotations[ai],
                ci=gt[ai].ci,
                num_spanning=spanning_by_hap[ai],
                meth=meth_by_hap[ai],
            ))
        if len(genotype) != 1 and genotype[0].seq != st.locus.tr \
                and genotype[1].seq == st.locus.tr:
            genotype[0], genotype[1] = genotype[1], genotype[0]
            classification = [1 - c for c in classification]
        return LocusResult(genotype, st.reads, st.spans, classification)
