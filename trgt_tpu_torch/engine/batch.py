"""The device hooks of the per-locus `workflow.analyze_tr` (counterpart
of `trgt_tpu/engine/batch.py`).

Within one locus, all (read x flank) alignments that miss the exact
substring path (ref: span_locater.rs:10-12; in clean HiFi data most reads
hit it, and the hits stay on the host) go to the flank kernel as one
batch, all labelings of one call to the Viterbi kernel, and the cluster
genotyper's pairwise distances to the edit-distance kernel. The batched
`BatchPipeline` is the main path; this engine serves callers of
`analyze_tr`.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.editdist import MAX_OPS, edit_distances_batch
from ..kernels.semiglobal import flank_align_batch_multi
from ..kernels.viterbi import viterbi_batch_multi

Span = Tuple[int, int]


class DeviceEngine:
    """The hooks on the port's kernels on `device`: CUDA kernels on a GPU,
    their plain PyTorch versions on the CPU."""

    def __init__(self, device: "torch.device"):
        self.device = device

    # ---- span location ----
    def batch_flank_aligner(self, lf_piece: bytes, rf_piece: bytes,
                            seqs: Sequence[bytes], threshold_frac: float,
                            scoring):
        """batch_aligner hook of genotype.span.find_tr_spans."""
        lf_spans: List[Optional[Span]] = [None] * len(seqs)
        rf_spans: List[Optional[Span]] = [None] * len(seqs)
        miss = []            # (spans, seq_idx, piece)
        for piece, spans in ((lf_piece, lf_spans), (rf_piece, rf_spans)):
            for i, s in enumerate(seqs):
                start = s.find(piece)
                if start != -1:
                    spans[i] = (start, start + len(piece))
                else:
                    miss.append((spans, i, piece))
        if miss:
            results = flank_align_batch_multi(
                [piece for _, _, piece in miss],
                [seqs[i] for _, i, _ in miss], scoring.mism_scr,
                scoring.gapo_scr, scoring.gape_scr, self.device)
            for (spans, i, _), (_score, matches, span) in zip(miss, results):
                if float(matches) >= threshold_frac:
                    spans[i] = span
        return lf_spans, rf_spans

    # ---- HMM labeling ----
    def viterbi(self, hmm, queries: Sequence[str]) -> List[List[int]]:
        return viterbi_batch_multi([hmm] * len(queries), queries,
                                   self.device)

    # ---- cluster distances ----
    def pair_distances(self, trs: Sequence[bytes]) -> np.ndarray:
        """The full (n, n) edit-distance matrix with the reference's skip
        bound: |len_i - len_j| where len_i * len_j > MAX_OPS (ref
        genotype_cluster.rs:231-247)."""
        n = len(trs)
        dist = np.zeros((n, n), dtype=np.float64)
        pair_idx, pairs = [], []
        for i in range(n):
            for j in range(i + 1, n):
                if len(trs[i]) * len(trs[j]) > MAX_OPS:
                    dist[i, j] = dist[j, i] = abs(len(trs[i]) - len(trs[j]))
                else:
                    pair_idx.append((i, j))
                    pairs.append((trs[i], trs[j]))
        if pairs:
            eds = edit_distances_batch(pairs, self.device)
            for (i, j), d in zip(pair_idx, eds):
                dist[i, j] = dist[j, i] = d
        return dist


def make_engine(device: Optional["torch.device"]) -> Optional[DeviceEngine]:
    """None (the host twins, as `--device host`) or the engine on
    `device`."""
    if device is None:
        return None
    return DeviceEngine(device)
