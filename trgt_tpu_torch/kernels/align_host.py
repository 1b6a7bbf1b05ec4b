"""Host (numpy) alignment kernels replacing WFA2-lib.

Replaces the reference's WFA2 FFI uses (ref: src/wfaligner.rs):
  - align_ends_free with pattern-global / text-free ends (span locater,
    ref: src/trgt/genotype/span_locater.rs:14-27)
  - align_end_to_end with CIGAR (consensus repair, ref: src/utils/align.rs)
  - edit distance score (cluster distance matrix,
    ref: src/trgt/genotype/genotype_cluster.rs:236-247)

These are affine-gap Gotoh DPs with match cost 0 (same optimal scores as
WFA2's penalty formulation). Traceback prefers diagonal, then deletion,
then insertion on ties.
"""

from typing import List, Optional, Tuple

import numpy as np

INF = np.int32(2 ** 30)

CigarOps = List[Tuple[int, str]]


def _sub_matrix(pattern: bytes, text: bytes, mism: int) -> np.ndarray:
    p = np.frombuffer(pattern, dtype=np.uint8)
    t = np.frombuffer(text, dtype=np.uint8)
    return np.where(p[:, None] == t[None, :], 0, mism).astype(np.int32)


def edit_distance(a: bytes, b: bytes) -> int:
    """Levenshtein distance via Myers' bit-parallel algorithm (score only)."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    if len(a) > len(b):
        a, b = b, a
    m = len(a)
    peq = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    pv = (1 << m) - 1
    mv = 0
    score = m
    high = 1 << (m - 1)
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        if ph & high:
            score += 1
        if mh & high:
            score -= 1
        ph = (ph << 1) | 1
        mh = mh << 1
        pv = (mh | ~(xv | ph)) & ((1 << m) - 1)
        mv = ph & xv
        pv &= (1 << m) - 1
        mv &= (1 << m) - 1
    return score


def _compress_ops(ops: List[str]) -> CigarOps:
    out: CigarOps = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, op))
    return out


# Above this many DP cells the quadratic traceback matrices (~22 B/cell)
# are replaced by the Myers-Miller linear-memory aligner — the analog of
# WFA's MemoryUltraLow mode (ref: src/wfaligner.rs:173-181) used for
# repeat-expansion-scale alleles.
LINEAR_FALLBACK_CELLS = 4_000_000

# Above this many cells the adaptive-band aligner (align_banded.py, the
# O(n·s) analog of WFA's wavefronts, ref: src/wfaligner.rs:489) is tried
# first: on near-identical pairs — the consensus-repair workload — it
# certifies optimality with a narrow band and returns the bit-identical
# CIGAR at a fraction of the cost; on divergent pairs it bows out and
# the quadratic/linear paths below run as before.
BANDED_MIN_CELLS = 250_000


def align_end_to_end(pattern: bytes, text: bytes, mism: int, gapo: int,
                     gape: int, tb: Optional[int] = None,
                     te: Optional[int] = None) -> Tuple[int, CigarOps]:
    """Global affine alignment; returns (cost, cigar with '='/'X'/'I'/'D').

    'I' consumes text, 'D' consumes pattern (WFA2 convention, matching
    repair_consensus at src/trgt/genotype/consensus.rs:5-41 where pattern
    is the backbone/reference).

    tb/te override the gap-open cost of a 'D' run anchored at the alignment
    start/end boundary (Myers-Miller recursion leaves; default gapo).
    """
    P, T = len(pattern), len(text)
    if P and T:
        native = _native_end_to_end(pattern, text, mism, gapo, gape,
                                    tb, te)
        if native is not None:
            return native
    if P and T and P * T > BANDED_MIN_CELLS:
        from .align_banded import align_end_to_end_banded
        banded = align_end_to_end_banded(pattern, text, mism, gapo, gape,
                                         tb=tb, te=te)
        if banded is not None:
            return banded
    if tb is None and te is None and P * T > LINEAR_FALLBACK_CELLS:
        from .align_linear import align_end_to_end_linear
        return align_end_to_end_linear(pattern, text, mism, gapo, gape)
    return align_end_to_end_quadratic(pattern, text, mism, gapo, gape,
                                      tb=tb, te=te)


# traceback bytes cap for the native banded aligner ((P+1)·Wb cells,
# 1 byte each); past this the Myers-Miller linear path takes over
_NATIVE_TB_BYTES = 400 * 1024 * 1024


def _native_end_to_end(pattern: bytes, text: bytes, mism: int, gapo: int,
                       gape: int, tb: Optional[int],
                       te: Optional[int]) -> Optional[Tuple[int, CigarOps]]:
    """Native (C++) adaptive-band pass with the SAME recurrences,
    certificate, and tie rules as align_banded.py / the quadratic DP
    (csrc/bamcodec.cpp trgt_banded_align; fuzz-equality enforced by
    tests/test_native_align.py). A band that grows to cover the whole
    matrix IS the full DP, so this path serves small pairs too — at C
    speed instead of numpy-row speed."""
    if gape <= 0:
        return None
    from ..io import native
    if native.get_lib() is None:
        return None
    P, T = len(pattern), len(text)
    tb_v = gapo if tb is None else tb
    te_v = gapo if te is None else te
    c_d = min(gapo, tb_v, te_v)
    W = 32
    while True:
        Wb = abs(T - P) + 2 * W + 1
        if (P + 1) * Wb > _NATIVE_TB_BYTES:
            return None                    # huge + divergent: linear path
        res = native.banded_align(pattern, text, mism, gapo, gape,
                                  tb_v, te_v, W)
        if res is None:
            return None
        rc, score, ops = res
        if rc == 0:
            return score, _compress_ops(ops.decode("latin-1"))
        # jump straight to the certifying slack (the failed pass's score
        # upper-bounds the true score; see align_banded.py)
        need = (score - gapo - c_d) // gape - abs(T - P) - 2
        W = max(2 * W, need // 2 + 1)


def align_end_to_end_quadratic(pattern: bytes, text: bytes, mism: int,
                               gapo: int, gape: int,
                               tb: Optional[int] = None,
                               te: Optional[int] = None
                               ) -> Tuple[int, CigarOps]:
    """The full-matrix Gotoh DP (always exact; O(P·T) memory). The
    banded and linear paths above must match its score — and, for the
    banded path, its CIGAR bit-for-bit (tests/test_align_banded.py)."""
    P, T = len(pattern), len(text)
    tb = gapo if tb is None else tb
    te = gapo if te is None else te
    if P == 0:
        return (gapo + gape * T if T else 0), ([(T, "I")] if T else [])
    if T == 0:
        return min(tb, te) + gape * P, [(P, "D")]
    sub = _sub_matrix(pattern, text, mism)

    H = np.full((P + 1, T + 1), INF, dtype=np.int32)
    E = np.full((P + 1, T + 1), INF, dtype=np.int32)  # gap in text ('D')
    F = np.full((P + 1, T + 1), INF, dtype=np.int32)  # gap in pattern ('I')
    # traceback: bits per cell
    HT = np.zeros((P + 1, T + 1), dtype=np.uint8)  # 0=diag,1=E,2=F
    ET = np.zeros((P + 1, T + 1), dtype=np.uint8)  # 0=open,1=extend
    FT = np.zeros((P + 1, T + 1), dtype=np.uint8)

    H[0, 0] = 0
    for i in range(1, P + 1):
        E[i, 0] = tb + gape * i
        H[i, 0] = E[i, 0]
        HT[i, 0] = 1
        ET[i, 0] = 1 if i > 1 else 0
    F[0, 1:] = gapo + gape * np.arange(1, T + 1, dtype=np.int32)
    H[0, 1:] = F[0, 1:]
    HT[0, 1:] = 2
    FT[0, 2:] = 1

    for i in range(1, P + 1):
        # E: gap in text (consume pattern)
        e_open = H[i - 1, :] + gapo + gape
        e_ext = E[i - 1, :] + gape
        E[i, :] = np.minimum(e_open, e_ext)
        ET[i, :] = (e_ext < e_open).astype(np.uint8)
        # column 0: the only possible run is origin-anchored (open = tb)
        E[i, 0] = tb + gape * i
        ET[i, 0] = 1 if i > 1 else 0
        # F: sequential along j — vectorize via cummin trick:
        # F[i,j] = min_k<=j (H[i,k] + gapo + gape*(j-k)) =
        #          gape*j + min cummin(H[i,k] - gape*k) ... but H[i,j]
        # depends on F[i,j]; H[i,j] = min(diag, E) before F, and F uses
        # H from same row left cells which may themselves come from F.
        # Opening from an F cell is never better than extending, so use
        # H' = min(diag, E) for openings:
        diag = H[i - 1, :-1] + sub[i - 1, :]
        h_no_f = np.minimum(
            np.concatenate(([INF], diag)), E[i, :])
        # cummin over (h_no_f[k] + gapo - gape*k), then F[i,j] =
        # gape*j + gape... opening at k→first gap cell k+1 costs
        # h_no_f[k] + gapo + gape*(j-k)
        j_idx = np.arange(T + 1, dtype=np.int64)
        open_base = h_no_f.astype(np.int64) + gapo - gape * j_idx
        cm = np.minimum.accumulate(open_base)
        F_row = np.full(T + 1, INF, dtype=np.int64)
        F_row[1:] = cm[:-1] + gape * (j_idx[1:] + 0)
        # F_row[j] = min_{k<j}(h_no_f[k] + gapo + gape*(j-k))
        F_row[1:] = cm[:-1] + gape * j_idx[1:]
        F[i, :] = np.minimum(F_row, INF).astype(np.int32)
        # FT: extend if the minimizing k < j-1 — recover via comparison
        f_open = np.full(T + 1, INF, dtype=np.int64)
        f_open[1:] = h_no_f[:-1].astype(np.int64) + gapo + gape
        FT[i, :] = (F[i, :] < f_open).astype(np.uint8)
        # H
        cand_diag = np.concatenate(([INF], diag))
        stacked = np.stack([cand_diag, E[i, :], F[i, :]])
        HT[i, :] = np.argmin(stacked, axis=0).astype(np.uint8)
        H[i, :] = np.min(stacked, axis=0)
        H[i, 0] = E[i, 0]
        HT[i, 0] = 1

    # traceback; a 'D' run ending at (P, T) may be cheaper once its open
    # is re-charged at the end-boundary cost te
    score = int(H[P, T])
    layer = int(HT[P, T])
    end_d = int(E[P, T]) - gapo + te
    if end_d < score:
        score, layer = end_d, 1
    ops: List[str] = []
    i, j = P, T
    while i > 0 or j > 0:
        if i > 0 and j > 0 and layer == 0:
            ops.append("=" if pattern[i - 1] == text[j - 1] else "X")
            i -= 1
            j -= 1
            layer = HT[i, j]
        elif layer == 1:
            ext = ET[i, j]
            ops.append("D")
            i -= 1
            layer = 1 if ext else HT[i, j]
        else:
            ext = FT[i, j]
            ops.append("I")
            j -= 1
            layer = 2 if ext else HT[i, j]
    ops.reverse()
    return score, _compress_ops(ops)


def align_ends_free_text(pattern: bytes, text: bytes, mism: int, gapo: int,
                         gape: int):
    """Affine alignment with pattern global, text free at both ends
    (the span-locater mode: align_ends_free(piece, 0, 0, read, len, len),
    ref: src/trgt/genotype/span_locater.rs:16-18).

    Returns (score, n_matches, (pattern_start, pattern_end),
    (text_start, text_end)) where spans run from the first to the last
    M/X column (ref: src/wfaligner.rs:864-908).
    """
    P, T = len(pattern), len(text)
    if P == 0 or T == 0:
        return 0, 0, (0, 0), (0, 0)
    from ..io import native
    if native.get_lib() is not None:
        res = native.endsfree_align(pattern, text, mism, gapo, gape)
        if res is not None:
            return res
    sub = _sub_matrix(pattern, text, mism)

    H = np.full((P + 1, T + 1), INF, dtype=np.int64)
    E = np.full((P + 1, T + 1), INF, dtype=np.int64)
    HT = np.zeros((P + 1, T + 1), dtype=np.uint8)
    ET = np.zeros((P + 1, T + 1), dtype=np.uint8)
    FT = np.zeros((P + 1, T + 1), dtype=np.uint8)
    F = np.full((P + 1, T + 1), INF, dtype=np.int64)

    H[0, :] = 0          # free text start
    for i in range(1, P + 1):
        E[i, 0] = gapo + gape * i
        H[i, 0] = E[i, 0]
        HT[i, 0] = 1
        ET[i, 0] = 1 if i > 1 else 0

    j_idx = np.arange(T + 1, dtype=np.int64)
    for i in range(1, P + 1):
        e_open = H[i - 1, :] + gapo + gape
        e_ext = E[i - 1, :] + gape
        E[i, :] = np.minimum(e_open, e_ext)
        ET[i, :] = (e_ext < e_open).astype(np.uint8)
        diag = H[i - 1, :-1] + sub[i - 1, :]
        h_no_f = np.minimum(np.concatenate(([INF], diag)), E[i, :])
        open_base = h_no_f + gapo - gape * j_idx
        cm = np.minimum.accumulate(open_base)
        F[i, 1:] = cm[:-1] + gape * j_idx[1:]
        f_open = np.full(T + 1, INF, dtype=np.int64)
        f_open[1:] = h_no_f[:-1] + gapo + gape
        FT[i, :] = (F[i, :] < f_open).astype(np.uint8)
        cand_diag = np.concatenate(([INF], diag))
        stacked = np.stack([cand_diag, E[i, :], F[i, :]])
        HT[i, :] = np.argmin(stacked, axis=0).astype(np.uint8)
        H[i, :] = np.min(stacked, axis=0)
        H[i, 0] = E[i, 0]
        HT[i, 0] = 1

    j_end = int(np.argmin(H[P, :]))
    score = int(H[P, j_end])

    # traceback from (P, j_end) to row 0
    i, j = P, j_end
    layer = HT[i, j]
    n_matches = 0
    p_start = p_end = t_start = t_end = None
    while i > 0:
        if j > 0 and layer == 0:
            is_match = pattern[i - 1] == text[j - 1]
            n_matches += int(is_match)
            if p_end is None:
                p_end, t_end = i, j
            p_start, t_start = i - 1, j - 1
            i -= 1
            j -= 1
            layer = HT[i, j]
        elif layer == 1:
            ext = ET[i, j]
            i -= 1
            layer = 1 if ext else HT[i, j]
        else:
            ext = FT[i, j]
            j -= 1
            layer = 2 if ext else HT[i, j]
    if p_end is None:
        return score, 0, (0, 0), (0, 0)
    return score, n_matches, (p_start, p_end), (t_start, t_end)
