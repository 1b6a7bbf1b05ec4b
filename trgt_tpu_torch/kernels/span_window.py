"""Certified seed-window banding for ends-free span location.

The span locater (ref: src/trgt/genotype/span_locater.rs:32-68) aligns a
flank piece (pattern, P ≈ 200-250bp) against a clipped read (text, up to
10-20kb) with pattern-global / text-free-ends affine DP — O(P·T) cells.
For HiFi reads the optimal alignment is near-identical to the flank, so
almost all of those cells are provably irrelevant. This module shrinks
the TEXT axis before dispatch, on BOTH the device kernel and the host
twin, with a certificate that makes the result bit-identical to the
full DP (score, match count, span, and tie-breaks):

  1. SEEDS. Tile the pattern with non-overlapping k-mers (k=8) and find
     every exact occurrence in the text (vectorized uint64 compare).
     Each hit proposes a diagonal d = j_hit - i_tile.
  2. WINDOWS. Any alignment whose error-column count D (mismatch
     columns + indel columns) satisfies D <= D_cap, where
         D_cap = (P - (2k-1)) // (2k),
     contains a clean run of >= 2k-1 pattern columns (pigeonhole over
     the <= D cuts), hence a fully-matched tile, hence one of the found
     diagonals; and its path stays within D_cap text columns of that
     diagonal (net indel length <= D <= D_cap). So the text window
     [d - D_cap, d + P + D_cap] around each hit diagonal covers the
     ENTIRE path of every such alignment. Overlapping windows merge;
     disjoint windows become separate problems of the same pattern.
  3. CERTIFICATE. After the banded DP returns its best score s*, every
     alignment with D error columns costs at least
         min_cost(D) = min(D*mism,                      all mismatches
                           cheapest mix with >= 1 gap run),
     which is nondecreasing in D, so score <= s* implies
     D <= max_errors_for_score(s*). If that bound is <= D_cap then ALL
     alignments scoring <= s* — including every co-optimal one — lie
     inside the computed windows, so the banded minimum is the true
     minimum, every cell on an optimal path holds its full-DP value,
     and the traceback tie-breaks (first-argmin end column,
     diag ≻ D ≻ I) resolve identically. Certificate failures (divergent
     text, e.g. a neighbouring read that does not contain the flank at
     all) are recomputed on the full text — correctness never depends
     on the seeds, only the work saved does.

Windows are reduced across a miss by (score, ascending window offset):
disjoint windows are processed in ascending text order and the first
strict minimum wins, which reproduces the full DP's first-argmin end
column because every co-optimal end lies inside some window and all
text positions in an earlier window precede those in a later one.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

SEED_K = 8
# below this text length even the banded DP saves too little to justify
# planning (the band itself is ~P + 2*d_cap columns of text)
MIN_TEXT_LEN = 256
# if the merged windows cover most of the text anyway, dispatch full
MAX_COVER_FRAC = 0.75


class SpanPlan:
    """Windowing plan for one (pattern, text) miss. `windows` is a
    sorted list of disjoint (lo, hi, dlo, dhi) entries: [lo, hi) is the
    text interval handed to the device kernel; [dlo, dhi] is the
    certified diagonal band (j - i, relative to the WINDOW text) the
    host kernel restricts to — band cells are a subset of window cells,
    and the module docstring's certificate argument makes both reduce
    to the same accepted result."""
    __slots__ = ("windows", "d_cap")

    def __init__(self, windows: List[Tuple[int, int, int, int]],
                 d_cap: int):
        self.windows = windows
        self.d_cap = d_cap


# a miss whose tiles hit the text more than this many times is
# repeat-degenerate (flank piece sharing motif content with the TR):
# its merged windows would fail the cover gate anyway, and the find
# loop itself was measurable at scale — bail to the full DP early
MAX_SEED_HITS = 256


def _seed_diagonals(pattern: bytes, text: bytes, k: int) -> List[int]:
    """All diagonals j - i where a non-overlapping pattern k-mer tile
    occurs exactly in the text (C-speed bytes.find scans); None when
    the hit cap is exceeded (caller dispatches the full text)."""
    deltas: List[int] = []
    find = text.find
    for i0 in range(0, len(pattern) - k + 1, k):
        tile = pattern[i0:i0 + k]
        j = find(tile)
        while j != -1:
            deltas.append(j - i0)
            if len(deltas) > MAX_SEED_HITS:
                return None
            j = find(tile, j + 1)
    return deltas


def plan_windows(pattern: bytes, text: bytes, mism: int, gapo: int,
                 gape: int, k: int = SEED_K) -> Optional[SpanPlan]:
    """Build the text windows + diagonal bands for one miss, or None
    when the full text should be dispatched (short text, no certifiable
    seeds, or windows that would not save work)."""
    P, T = len(pattern), len(text)
    if T < MIN_TEXT_LEN or min(mism, gape) <= 0:
        return None
    d_cap = (P - (2 * k - 1)) // (2 * k)
    if d_cap <= 0:
        return None
    deltas = _seed_diagonals(pattern, text, k)
    if not deltas:
        return None  # no certifiable seeds (or hit cap): full DP
    deltas = sorted(set(deltas))
    # merge seed diagonals whose text windows overlap; each merged
    # window keeps its member-diagonal extent for the band
    groups: List[Tuple[int, int]] = []    # (dmin, dmax) per window
    cur_lo, cur_hi = deltas[0], deltas[0]
    for d in deltas[1:]:
        # windows [d1 - d_cap, d1 + P + d_cap) and [d2 - d_cap, ...)
        # overlap iff d2 - d1 <= P + 2*d_cap
        if d - cur_hi <= P + 2 * d_cap:
            cur_hi = d
        else:
            groups.append((cur_lo, cur_hi))
            cur_lo = cur_hi = d
    groups.append((cur_lo, cur_hi))
    windows: List[Tuple[int, int, int, int]] = []
    band_cols = 0
    for dmin, dmax in groups:
        lo = max(dmin - d_cap, 0)
        hi = min(dmax + P + d_cap, T)
        # diagonal band relative to the window slice text[lo:hi]
        windows.append((lo, hi, dmin - d_cap - lo, dmax + d_cap - lo))
        band_cols += dmax - dmin + 2 * d_cap + 1
    # gate on the BAND cells (the host cost; the device window is wider
    # but vectorized): repetitive flanks whose seeds hit everywhere
    # degenerate to the full DP
    if band_cols >= MAX_COVER_FRAC * T:
        return None
    return SpanPlan(windows, d_cap)


def max_errors_for_score(score: float, mism: int, gapo: int,
                         gape: int) -> int:
    """Largest error-column count D any alignment of cost <= score can
    have. An alignment with mm mismatch columns and I indel columns in
    r >= 1 gap runs costs mm*mism + r*gapo + I*gape >= min_cost(D),
    D = mm + I; minimizing over the split gives the bounds below."""
    s = int(score)
    d_all_mism = s // mism
    if mism > gape:
        # cheapest error columns are indels: one run of length D
        d_with_gap = (s - gapo) // gape if s >= gapo + gape else 0
    else:
        # one 1-long gap run, the rest mismatches
        d_with_gap = (s - gapo - gape) // mism + 1 \
            if s >= gapo + gape else 0
    return max(d_all_mism, d_with_gap, 0)


def certified(plan: SpanPlan, score: float, mism: int, gapo: int,
              gape: int) -> bool:
    """True iff the banded result provably equals the full DP (see
    module docstring step 3)."""
    return max_errors_for_score(score, mism, gapo, gape) <= plan.d_cap


def expand(plans: Sequence[Optional[SpanPlan]], patterns: Sequence[bytes],
           texts: Sequence[bytes]):
    """Flatten (miss, window) pairs into one dispatch list.

    Returns (sub_patterns, sub_texts, sub_bands, owners) where
    owners[i] = (miss_index, window_lo, is_windowed) and sub_bands[i]
    is the window-relative (dlo, dhi) diagonal band or None for
    full-text problems."""
    sub_patterns: List[bytes] = []
    sub_texts: List[bytes] = []
    sub_bands: List[Optional[Tuple[int, int]]] = []
    owners: List[Tuple[int, int, bool]] = []
    for mi, plan in enumerate(plans):
        if plan is None:
            sub_patterns.append(patterns[mi])
            sub_texts.append(texts[mi])
            sub_bands.append(None)
            owners.append((mi, 0, False))
        else:
            for lo, hi, dlo, dhi in plan.windows:
                sub_patterns.append(patterns[mi])
                sub_texts.append(texts[mi][lo:hi])
                sub_bands.append((dlo, dhi))
                owners.append((mi, lo, True))
    return sub_patterns, sub_texts, sub_bands, owners


def reduce_and_certify(plans: Sequence[Optional[SpanPlan]], owners,
                       sub_results, n_miss: int, mism: int, gapo: int,
                       gape: int):
    """Fold per-window results back to per-miss results and collect the
    indices whose certificate failed (callers recompute those on the
    full text). sub_results items are (score, matches, (t_start, t_end))
    in window-local text coordinates."""
    out: List[Optional[tuple]] = [None] * n_miss
    windowed = [False] * n_miss
    for (mi, lo, is_win), (score, matches, tspan) in zip(owners,
                                                         sub_results):
        cand = (score, matches, (tspan[0] + lo, tspan[1] + lo))
        cur = out[mi]
        # windows arrive in ascending text order; strict < keeps the
        # earliest co-optimal window = the full DP's first-argmin end
        if cur is None or cand[0] < cur[0]:
            out[mi] = cand
        windowed[mi] = windowed[mi] or is_win
    redo = [mi for mi in range(n_miss)
            if windowed[mi]
            and not certified(plans[mi], out[mi][0], mism, gapo, gape)]
    return out, redo
