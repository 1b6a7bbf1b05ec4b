"""Linear-memory global affine alignment (Myers-Miller / Hirschberg).

Replaces the reference's WFA low-memory modes for long alleles
(ref: src/wfaligner.rs:173-181 MemoryUltraLow, src/commands/genotype.rs:82-92):
consensus repair of repeat-expansion alleles reaches tens of kb, where the
quadratic traceback matrices of kernels/align_host.align_end_to_end (and the
device kernel's (P+1, B, T+1) direction-bit tensor) do not fit in memory.

Divide-and-conquer on pattern rows (Myers & Miller 1988): forward and
backward cost rows are numpy-vectorized (O(T) memory per row), the optimal
crossing column of the middle row is found where forward and backward costs
meet, and only leaf blocks (<= _SMALL_CELLS cells) run the full quadratic DP
with traceback. Gap runs crossing a split row are handled with boundary gap
open-costs (tb at the start boundary, te at the end boundary), so scores are
exactly optimal; on ties the chosen co-optimal path may differ from the
quadratic kernel's (same caveat as the device kernel, e2e_device.py:8-11).
"""

from typing import List, Tuple

import numpy as np

CigarOps = List[Tuple[int, str]]

_INF = np.int64(1) << 40

# Leaf blocks at or below this many cells run the quadratic host DP.
_SMALL_CELLS = 4096


def _pass_rows(pattern: bytes, text: bytes, mism: int, gapo: int, gape: int,
               tb: int) -> Tuple[np.ndarray, np.ndarray]:
    """Consume all pattern rows; return the final (H, D) cost rows.

    H[j] = optimal cost aligning `pattern` against text[:j].
    D[j] = same, constrained to end in a 'D' op (gap in text, consuming
    pattern); the final run's open is charged gapo, except the run anchored
    at the alignment origin (column 0), which is charged `tb`.
    """
    T = len(text)
    t_arr = np.frombuffer(text, dtype=np.uint8) if T else \
        np.empty(0, dtype=np.uint8)
    j_idx = np.arange(T + 1, dtype=np.int64)
    H = np.empty(T + 1, dtype=np.int64)
    H[0] = 0
    if T:
        H[1:] = gapo + gape * j_idx[1:]
    D = np.full(T + 1, _INF, dtype=np.int64)
    for i, pc in enumerate(np.frombuffer(pattern, dtype=np.uint8), start=1):
        D = np.minimum(D + gape, H + gapo + gape)
        D[0] = tb + gape * i
        sub = np.where(t_arr == pc, 0, mism)
        diag = H[:-1] + sub
        h_no_i = np.minimum(
            np.concatenate(([_INF], diag)), D)
        # I[j] = min_{k<j} (h_no_i[k] + gapo + gape*(j-k)); opening from an
        # I cell is never better than extending, so openings use h_no_i.
        open_base = h_no_i + gapo - gape * j_idx
        cm = np.minimum.accumulate(open_base)
        I = np.full(T + 1, _INF, dtype=np.int64)
        if T:
            I[1:] = cm[:-1] + gape * j_idx[1:]
        H = np.minimum(h_no_i, I)
    return H, D


def _align_m1(pattern: bytes, text: bytes, mism: int, gapo: int, gape: int,
              tb: int, te: int, out: List[Tuple[int, str]]) -> None:
    """Direct solve for a single pattern row."""
    T = len(text)
    # option A: delete the row, insert all text (one run each). The delete
    # run touches both boundaries; it opens with the cheaper of tb/te.
    cost_del = min(tb, te) + gape + ((gapo + gape * T) if T else 0)
    # option B: pair pattern[0] with text[j], inserts before/after.
    best_j, best_cost = -1, cost_del
    t_arr = np.frombuffer(text, dtype=np.uint8)
    if T:
        pre = np.where(np.arange(T) > 0,
                       gapo + gape * np.arange(T, dtype=np.int64), 0)
        post_len = T - 1 - np.arange(T, dtype=np.int64)
        post = np.where(post_len > 0, gapo + gape * post_len, 0)
        subs = np.where(t_arr == pattern[0], 0, mism)
        costs = pre + subs + post
        j = int(np.argmin(costs))
        if int(costs[j]) <= best_cost:
            best_j, best_cost = j, int(costs[j])
    if best_j < 0:
        out.append((1, "D"))
        if T:
            out.append((T, "I"))
        return
    if best_j > 0:
        out.append((best_j, "I"))
    out.append((1, "=" if pattern[0] == t_arr[best_j] else "X"))
    if T - 1 - best_j > 0:
        out.append((T - 1 - best_j, "I"))


def _solve(pattern: bytes, text: bytes, mism: int, gapo: int, gape: int,
           tb: int, te: int, out: List[Tuple[int, str]]) -> None:
    M, T = len(pattern), len(text)
    if M == 0:
        if T:
            out.append((T, "I"))
        return
    if T == 0:
        out.append((M, "D"))
        return
    if M == 1:
        _align_m1(pattern, text, mism, gapo, gape, tb, te, out)
        return
    if M * T <= _SMALL_CELLS:
        from .align_host import align_end_to_end
        out.extend(align_end_to_end(pattern, text, mism, gapo, gape,
                                    tb=tb, te=te)[1])
        return
    mid = M // 2
    Hf, Df = _pass_rows(pattern[:mid], text, mism, gapo, gape, tb)
    Hb_r, Db_r = _pass_rows(pattern[mid:][::-1], text[::-1], mism, gapo,
                            gape, te)
    cand_h = Hf + Hb_r[::-1]
    # A 'D' run crossing the split row is open in both halves; refund one
    # standard open (boundary-anchored opens were charged tb/te instead and
    # their partner half carries the gapo being refunded).
    cand_d = Df + Db_r[::-1] - gapo
    j_h = int(np.argmin(cand_h))
    j_d = int(np.argmin(cand_d))
    if int(cand_h[j_h]) <= int(cand_d[j_d]):
        _solve(pattern[:mid], text[:j_h], mism, gapo, gape, tb, gapo, out)
        _solve(pattern[mid:], text[j_h:], mism, gapo, gape, gapo, te, out)
    else:
        # pattern[mid-1] and pattern[mid] are deleted by the crossing run;
        # the adjacent boundary opens in the children cost 0 (merged).
        _solve(pattern[:mid - 1], text[:j_d], mism, gapo, gape, tb, 0, out)
        out.append((2, "D"))
        _solve(pattern[mid + 1:], text[j_d:], mism, gapo, gape, 0, te, out)


def align_end_to_end_linear(pattern: bytes, text: bytes, mism: int,
                            gapo: int, gape: int) -> Tuple[int, CigarOps]:
    """Global affine alignment in O(min-dim) memory; returns (cost, cigar)
    with '='/'X'/'I'/'D' ops ('I' consumes text, 'D' consumes pattern) —
    the same convention as align_host.align_end_to_end."""
    chunks: List[Tuple[int, str]] = []
    _solve(pattern, text, mism, gapo, gape, gapo, gapo, chunks)
    ops: CigarOps = []
    for length, op in chunks:
        if length <= 0:
            continue
        if ops and ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + length, op)
        else:
            ops.append((length, op))
    cost = 0
    for length, op in ops:
        if op == "X":
            cost += mism * length
        elif op in "ID":
            cost += gapo + gape * length
    return cost, ops
