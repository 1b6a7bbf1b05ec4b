"""Adaptive-band global affine alignment: O((P+T)·W) work where W grows
with the alignment cost — the O(n·s) replacement for quadratic DP on
long NEAR-IDENTICAL pairs, which is exactly the consensus-repair
workload (backbone vs reads of the same allele; ref: src/utils/align.rs
affine 2,5,1 and WFA2-lib's O(score) wavefronts, src/wfaligner.rs:5-10).

Unlike a literal wavefront, the band keeps the EXACT Gotoh recurrences
and tie-break rules of kernels/align_host.align_end_to_end (diagonal ≻
'D'(E) ≻ 'I'(F) on H ties; gap-open preferred over extend on ties), so
the returned CIGAR is bit-identical to the quadratic DP whenever the
optimality certificate holds — not just co-optimal. The certificate:

  a global path whose diagonal offset j−i ever leaves
  [min(0,T−P)−W, max(0,T−P)+W] must spend insertions to get there and
  deletions to return to the end offset T−P (or vice versa): exceeding
  the band above at offset hi+1 needs I ≥ hi+1 and D ≥ hi+1−(T−P), and
  symmetrically below — in both cases total indels ≥ 2W+2+|T−P|, so it
  costs ≥ gapo + min(gapo,tb,te) + gape·(2W+2+|T−P|). If the banded
  score is strictly below that bound, the true optimum lies in the
  band; then every cell ON the optimal path has exact (full-DP) H/E/F
  values, inflated out-of-band-dependent values only ever appear as
  strictly-larger losers (values never decrease under banding, and the
  first-minimum tie rule picks the earliest candidate, whose value is
  exact whenever it wins), so every traceback comparison resolves as in
  the full DP — score AND CIGAR are exact, ties included.

On certificate failure the band doubles (geometric total cost ≤ 4/3 of
the final pass); if the band would exceed the memory cap before
certifying, returns None and the caller falls back (align_host →
align_linear for huge pairs, quadratic for mid-size).
"""

from typing import List, Optional, Tuple

import numpy as np

CigarOps = List[Tuple[int, str]]

INF = np.int64(1) << 40

# traceback tables cost 3 bytes/cell; cap the band before they exceed
# ~400MB (beyond that Myers-Miller linear memory is the better tool)
_MAX_TB_BYTES = 400 * 1024 * 1024


def _banded_pass(pattern: bytes, text: bytes, mism: int, gapo: int,
                 gape: int, tb: int, te: int, W: int):
    """One banded DP pass with slack W. Returns (score, layer, HT, ET,
    FT, lo, k_end, E_last) or None if the certificate fails."""
    P, T = len(pattern), len(text)
    lo = min(0, T - P) - W
    hi = max(0, T - P) + W
    Wb = hi - lo + 1
    p_arr = np.frombuffer(pattern, dtype=np.uint8)
    t_arr = np.frombuffer(text, dtype=np.uint8)
    k_idx = np.arange(Wb, dtype=np.int64)

    HT = np.zeros((P + 1, Wb), dtype=np.uint8)  # 0=diag,1=E,2=F
    ET = np.zeros((P + 1, Wb), dtype=np.uint8)  # 0=open,1=extend
    FT = np.zeros((P + 1, Wb), dtype=np.uint8)

    # row 0: j = lo + k; H[0,0]=0, H[0,j]=gapo+gape*j ('I' run), matching
    # align_host.align_end_to_end's init (F[0,1:] open at col 1)
    j_row = lo + k_idx
    valid0 = (j_row >= 0) & (j_row <= T)
    H_prev = np.where(valid0 & (j_row > 0), gapo + gape * j_row, INF)
    H_prev = np.where(valid0 & (j_row == 0), 0, H_prev)
    HT[0] = np.where(j_row > 0, 2, 0)
    FT[0] = np.where(j_row > 1, 1, 0)
    E_prev = np.full(Wb, INF, dtype=np.int64)
    E_last = E_prev

    for i in range(1, P + 1):
        j_row = i + lo + k_idx                 # text column of each lane
        valid = (j_row >= 0) & (j_row <= T)
        # E (gap in text, 'D'): from (i-1, j) = lane k+1 of row i-1
        H_up = np.concatenate([H_prev[1:], [INF]])
        E_up = np.concatenate([E_prev[1:], [INF]])
        e_open = H_up + gapo + gape
        e_ext = E_up + gape
        E_row = np.minimum(e_open, e_ext)
        ET[i] = (e_ext < e_open).astype(np.uint8)
        # column 0 (k0): only the origin-anchored run exists (open = tb)
        k0 = -(i + lo)
        if 0 <= k0 < Wb:
            E_row[k0] = tb + gape * i
            ET[i, k0] = 1 if i > 1 else 0
        # diagonal: (i-1, j-1) is the SAME lane k of row i-1
        tj = j_row - 1                          # text char consumed
        tchar = t_arr[np.clip(tj, 0, T - 1)] if T else np.zeros(Wb, np.uint8)
        sub = np.where(tchar == p_arr[i - 1], 0, mism).astype(np.int64)
        diag = np.where((tj >= 0) & (tj < T), H_prev + sub, INF)
        h_no_f = np.minimum(diag, E_row)
        h_no_f = np.where(valid, h_no_f, INF)
        # F (gap in pattern, 'I'): within-row chain over lanes; opening
        # from an F cell is never better than extending (same trick as
        # the full DP), so openings use h_no_f
        open_base = h_no_f + gapo - gape * k_idx
        cm = np.minimum.accumulate(open_base)
        F_row = np.full(Wb, INF, dtype=np.int64)
        F_row[1:] = cm[:-1] + gape * k_idx[1:]
        np.minimum(F_row, INF, out=F_row)
        f_open = np.full(Wb, INF, dtype=np.int64)
        f_open[1:] = h_no_f[:-1] + gapo + gape
        FT[i] = (F_row < f_open).astype(np.uint8)
        # H: diag ≻ E ≻ F on ties (np.argmin picks the first minimum)
        stacked = np.stack([diag, E_row, F_row])
        HT[i] = np.argmin(stacked, axis=0).astype(np.uint8)
        H_row = np.min(stacked, axis=0)
        if 0 <= k0 < Wb:
            H_row[k0] = E_row[k0]
            HT[i, k0] = 1
        H_row = np.where(valid, H_row, INF)
        E_row = np.where(valid, E_row, INF)
        H_prev, E_prev = H_row, E_row
        E_last = E_row

    k_end = T - P - lo
    score = int(H_prev[k_end])
    layer = int(HT[P, k_end])
    end_d = int(E_last[k_end]) - gapo + te
    if end_d < score:
        score, layer = end_d, 1
    # exit-cost bound (see module docstring); min(gapo,tb,te) accounts
    # for boundary-anchored 'D' runs whose open may be cheaper than gapo
    # (tb/te from the Myers-Miller recursion leaves)
    bound = gapo + min(gapo, tb, te) + gape * (2 * W + 2 + abs(T - P))
    if score >= bound:
        return None, score                      # certificate failed
    return (score, layer, HT, ET, FT, lo, k_end), score


def align_end_to_end_banded(pattern: bytes, text: bytes, mism: int,
                            gapo: int, gape: int,
                            tb: Optional[int] = None,
                            te: Optional[int] = None
                            ) -> Optional[Tuple[int, CigarOps]]:
    """Banded global affine alignment; (cost, cigar) bit-identical to
    align_host.align_end_to_end, or None if the band would exceed the
    memory cap before the optimality certificate holds (caller falls
    back to the unbanded paths). Assumes non-empty pattern and text."""
    P, T = len(pattern), len(text)
    if P == 0 or T == 0 or gape <= 0:
        return None                  # certificate needs gape ≥ 1
    tb = gapo if tb is None else tb
    te = gapo if te is None else te
    c_d = min(gapo, tb, te)
    W = 32
    spent_cells = 0
    quad_cells = (P + 1) * (T + 1)
    res = None
    while True:
        Wb = abs(T - P) + 2 * W + 1
        next_cells = (P + 1) * Wb
        # keep total banded work below the quadratic DP's; past that the
        # fallback paths are the better tool
        if spent_cells + next_cells > quad_cells:
            return None
        if 3 * next_cells > _MAX_TB_BYTES:
            return None
        res, got_score = _banded_pass(pattern, text, mism, gapo, gape,
                                      tb, te, W)
        spent_cells += next_cells
        if res is not None:
            break
        # the failed pass's score upper-bounds the true score, so the
        # slack that certifies it is reachable in ONE more pass (widening
        # the band can only lower the score further)
        need = (got_score - gapo - c_d) // gape - abs(T - P) - 2
        W = max(2 * W, need // 2 + 1)
    score, layer, HT, ET, FT, lo, k_end = res

    # traceback in band coordinates (k = j - i - lo); identical rules to
    # align_host.align_end_to_end's
    ops: List[str] = []
    i, k = P, k_end
    while i > 0 or (i + lo + k) > 0:
        j = i + lo + k
        if i > 0 and j > 0 and layer == 0:
            ops.append("=" if pattern[i - 1] == text[j - 1] else "X")
            i -= 1                       # diag: same lane
            layer = HT[i, k]
        elif layer == 1:
            ext = ET[i, k]
            ops.append("D")
            i -= 1
            k += 1                       # (i-1, j) is lane k+1
            layer = 1 if ext else HT[i, k]
        else:
            ext = FT[i, k]
            ops.append("I")
            k -= 1                       # (i, j-1) is lane k-1
            layer = 2 if ext else HT[i, k]
        assert 0 <= k < HT.shape[1], "banded traceback left the band"
    ops.reverse()
    out: CigarOps = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, op))
    return score, out
