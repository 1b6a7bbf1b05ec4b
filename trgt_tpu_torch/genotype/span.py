"""Spanning-read locater (ref: src/trgt/genotype/span_locater.rs).

For each read, find where the left/right reference flanks align: exact
substring search first, then ends-free affine alignment with a
min-flank-identity threshold. The alignment fallback is batched — in the
device path all (read × flank) problems run as one Pallas semiglobal DP
batch; the host path loops the numpy kernel.
"""

from typing import List, Optional, Sequence, Tuple

from ..kernels.align_host import align_ends_free_text

Span = Tuple[int, int]


def _find_one(piece: bytes, seq: bytes, threshold_frac: float,
              scoring) -> Optional[Span]:
    # exact fast path (ref: span_locater.rs:10-12)
    start = seq.find(piece)
    if start != -1:
        return (start, start + len(piece))
    _score, n_matches, _pspan, tspan = align_ends_free_text(
        piece, seq, scoring.mism_scr, scoring.gapo_scr, scoring.gape_scr)
    if float(n_matches) >= threshold_frac:
        return tspan
    return None


def find_spans(piece: bytes, seqs: Sequence[bytes], threshold_frac: float,
               scoring) -> List[Optional[Span]]:
    return [_find_one(piece, s, threshold_frac, scoring) for s in seqs]


def find_tr_spans(lf: bytes, rf: bytes, seqs: Sequence[bytes],
                  search_flank_len: int, min_flank_id_frac: float,
                  scoring, batch_aligner=None) -> List[Optional[Span]]:
    # ref: span_locater.rs:32-68
    lf_piece = lf[len(lf) - search_flank_len:]
    rf_piece = rf[:search_flank_len]
    threshold_frac = search_flank_len * min_flank_id_frac

    if batch_aligner is not None:
        lf_spans, rf_spans = batch_aligner(lf_piece, rf_piece, seqs,
                                           threshold_frac, scoring)
    else:
        lf_spans = find_spans(lf_piece, seqs, threshold_frac, scoring)
        rf_spans = find_spans(rf_piece, seqs, threshold_frac, scoring)

    spans: List[Optional[Span]] = []
    for lf_span, rf_span in zip(lf_spans, rf_spans):
        if lf_span is None or rf_span is None:
            spans.append(None)
        elif lf_span[1] <= rf_span[0]:
            spans.append((lf_span[1], rf_span[0]))
        else:
            spans.append(None)  # discordant flanks
    return spans
