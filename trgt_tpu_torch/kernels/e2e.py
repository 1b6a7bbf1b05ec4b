"""Batched end-to-end affine alignment with CIGAR (consensus repair).

Counterpart of `trgt_tpu.kernels.e2e_device.e2e_align_batch`, whose
device code is the XLA scan `_e2e_scan` followed by the host
`_traceback`. The CUDA kernels are in `csrc/e2e.cu`; each does the scan
and the traceback in one launch. Two classes:

  full matrix  every cell of (P+1) x (T+1), one byte of direction bits a
               cell: problems whose bucketed matrix holds at most
               FULL_MATRIX_CELLS cells
  band         only the cells with j - i in [min(0,T-P) - W, max(0,T-P)
               + W], one byte a band cell at [i][j - i - lo], the cells
               outside read as INF: everything larger. A problem comes
               back `certified` when its band covers the whole matrix or
               its score is strictly below gapo + gapo + gape * (2W + 2 +
               |T-P|); score and CIGAR are then the full matrix's, ties
               included (proof in kernels/align_banded.py)

Layers:
  e2e_align_batch   (pattern, text) byte pairs in, [(score, cigar)] out.
                    An empty side is answered on the host. Band problems
                    start at W = BAND_W0; those that come back
                    uncertified are launched again at the width of the
                    host aligner's own schedule (`align_host.
                    _native_end_to_end`), until a problem's band would
                    pass MAX_BAND_BYTES (the host's cap on the same
                    array) or MAX_BAND_WIDTH lanes: only those go to
                    `align_host.align_end_to_end`. With the host's
                    schedule and no larger a cap, the kernel answers
                    only where the host's own certified pass would.
  e2e_scan,         dispatch on the tensors' device: CPU tensors run the
  e2e_banded        plain version, CUDA tensors launch the kernel,
                    anything else raises
  e2e_scan_plain,   the plain PyTorch versions (any device): rows in
  e2e_banded_plain  tensor ops, then `traceback_runs` on the host

`e2e_scan` returns (score, bits, runs, n_runs), `e2e_banded` these and
`certified`:
  score      (B,) int32           H[len_p, len_t]
  bits       (B, P+1, T+1) or (B, P+1, width) uint8: per cell choice
             (0 diag, 1 D, 2 I) | D-extend << 2 | I-extend << 3; 0 outside
             rows <= len_p, columns <= len_t (and outside the band); None
             from a kernel launched with keep_bits false
  runs       (B, P+T) int32       run-length CIGAR ops, length << 2 | op
                                  (0 '=', 1 'X', 2 'D', 3 'I'), the
                                  alignment's LAST run first; 0 past
                                  n_runs unless keep_bits is false
  n_runs     (B,) int32
  certified  (B,) bool

Tie rules (held exactly, see csrc/e2e.cu): diagonal over D over I, gap
open over extend. CIGARs are byte-identical to
`align_host.align_end_to_end`.

Where the traceback runs: on the card, by one warp of the block that
scanned the problem, 32 cells of the path a round of loads. The
alternative, fetching the bits and walking them on the host as the
reference does, moves a byte a cell over PCIe and then pays a Python loop
of P+T steps.
"""

import os
import threading
import time
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import mesh
from . import telemetry
from .align_host import _NATIVE_TB_BYTES, align_end_to_end
from .bucket import bucket

# problems and DP cells ((len_p + 1) * (len_t + 1)) that e2e_align_batch
# sent each way: kernel_* (full-matrix class), band_problems and
# band_full_cells (the band class's problems and the cells of their full
# matrices), band_cells (band cells computed, (len_p + 1) * Wb summed over
# every pass), band_relaunches (passes after a problem's first),
# host_problems and host_cells (over the band's caps, or gape <= 0),
# empty_problems; host_seconds is the wall time the host-routed alignments
# took. Summed over the calls of a process, the mesh's shards included.
routed: Counter = Counter()
_ROUTED_LOCK = threading.Lock()

CigarOps = List[Tuple[int, str]]

# A problem whose bucketed (P+1) * (T+1) is at most this takes the
# full-matrix class, everything larger the band class. On an H100 a
# pattern row costs the full-matrix class 0.22-0.25 us up to 128 columns,
# 0.37 us up to 256 and 0.54 us up to 512, the band class 0.20-0.23 us up
# to 512 band lanes (`chip_profile.py scaling`, PERF.md): from 128 columns
# on the band is the faster even with a second pass, and under that its
# 65 lanes would cover most of the matrix.
FULL_MATRIX_CELLS = 1 << 14
# the band slack of a problem's first pass, as the host aligner's
BAND_W0 = 32
# caps of the band class: the bytes of one problem's band bits (the host
# aligner gives up its certified pass at the same size), and the lanes of
# a band (three ints a lane in the kernel's shared memory)
MAX_BAND_BYTES = _NATIVE_TB_BYTES
MAX_BAND_WIDTH = 16384
# bound on the direction-bit array of one launch (one byte per cell): a
# problem at MAX_BAND_BYTES fits, or a thousand smaller ones
MAX_BITS_BYTES = 1 << 30

_INF = 1 << 40
# the kernels' infinity: the banded plain version mirrors their arithmetic
_BAND_INF = 1 << 29
_KEY = 1 << 21          # column index packing for the plain scan
_OPS = "=XDI"


def traceback_runs(bits: np.ndarray, pattern: bytes, text: bytes,
                   lo: Optional[int] = None) -> List[int]:
    """The reference's `_traceback` over one problem's bits, returning
    encoded runs (length << 2 | op), last run first. `bits` is (rows,
    columns), or with `lo` (rows, band lanes): cell (i, j) at [i, j - i -
    lo]."""
    # cell (i, j) is bits[i, j - skew * i - lo]
    skew, lo = (0, 0) if lo is None else (1, lo)
    i, j = len(pattern), len(text)
    runs: List[int] = []
    cur_op, cur_len = -1, 0

    def emit(op):
        nonlocal cur_op, cur_len
        if op == cur_op:
            cur_len += 1
        else:
            if cur_len:
                runs.append((cur_len << 2) | cur_op)
            cur_op, cur_len = op, 1

    while i > 0 or j > 0:
        b = int(bits[i, j - skew * i - lo])
        choice = b & 3
        if i == 0:
            choice = 2
        if j == 0 and i > 0:
            choice = 1
        if choice == 0:
            emit(0 if pattern[i - 1] == text[j - 1] else 1)
            i -= 1
            j -= 1
        elif choice == 1:
            emit(2)
            ext = bool(b & 4)
            i -= 1
            while ext and i > 0:
                b = int(bits[i, j - skew * i - lo])
                emit(2)
                ext = bool(b & 4)
                i -= 1
        else:
            emit(3)
            ext = bool(b & 8)
            j -= 1
            while ext and j > 0:
                b = int(bits[i, j - skew * i - lo])
                emit(3)
                ext = bool(b & 8)
                j -= 1
    if cur_len:
        runs.append((cur_len << 2) | cur_op)
    return runs


def decode_runs(runs: Sequence[int]) -> CigarOps:
    """Encoded runs, last run first → [(length, op)] in alignment order."""
    return [(r >> 2, _OPS[r & 3]) for r in reversed(runs)]


def e2e_scan_plain(pattern: torch.Tensor, text: torch.Tensor,
                   len_p: torch.Tensor, len_t: torch.Tensor, mism: int,
                   gapo: int, gape: int):
    """Plain PyTorch version of the e2e kernel, on any device.

    pattern (B, P) uint8, text (B, T) uint8, len_p and len_t (B,) lengths
    clamped to the widths. Rows walk the pattern as `_e2e_scan` does; the
    insertion chain's rightmost argmin is a cummin over keys that pack
    the column index, as in `flank_align_plain`. The traceback runs on
    the host over the bits."""
    B, P = pattern.shape
    T = text.shape[1]
    if T + 1 >= _KEY:
        raise ValueError(f"text width {T} exceeds the plain version's "
                         f"{_KEY - 2} columns")
    dev = text.device
    i64 = torch.int64
    go_ge = gapo + gape
    ge = gape
    lp = len_p.to(i64).clamp(0, P)
    lt = len_t.to(i64).clamp(0, T)
    n = T + 1
    j = torch.arange(n, device=dev, dtype=i64)
    col_ok = j[None, :] <= lt[:, None]
    inf_col = torch.full((B, 1), _INF, device=dev, dtype=i64)
    zero_col = torch.zeros((B, 1), device=dev, dtype=i64)
    H = torch.where(j == 0, 0, gapo + ge * j).expand(B, n)
    D = torch.full((B, n), _INF, device=dev, dtype=i64)
    bits = torch.zeros((B, P + 1, n), dtype=torch.uint8, device=dev)
    bits0 = torch.where(j == 0, 0, torch.where(j == 1, 2, 2 | 8))
    bits[:, 0, :] = torch.where(col_ok, bits0, 0).to(torch.uint8)
    score = H.gather(1, lt[:, None])[:, 0]
    txt = text.to(i64)
    pat = pattern.to(i64)
    for i in range(1, P + 1):
        d_open = H + go_ge
        d_ext = D + ge
        te = d_ext < d_open
        d_row = torch.where(te, d_ext, d_open)
        sub = torch.where(txt == pat[:, i - 1:i], 0, mism)
        diag = torch.cat([inf_col, H[:, :-1] + sub], dim=1)
        td = d_row < diag
        nv = torch.where(td, d_row, diag)
        base = nv + go_ge - ge * j - ge
        cm = torch.cummin(base * _KEY + (_KEY - 1 - j), dim=1).values
        val = torch.div(cm, _KEY, rounding_mode="floor")
        kst = (_KEY - 1) - (cm - val * _KEY)
        i_row = torch.cat([inf_col, val[:, :-1] + ge * j[1:]], dim=1)
        k_star = torch.cat([zero_col, kst[:, :-1]], dim=1)
        ti = i_row < nv
        H = torch.where(ti, i_row, nv)
        D = d_row
        cell = torch.where(ti, 2, torch.where(td, 1, 0)) | (te.to(i64) << 2) \
            | ((k_star != j - 1).to(i64) << 3)
        row_ok = col_ok & (i <= lp)[:, None]
        bits[:, i, :] = torch.where(row_ok, cell, 0).to(torch.uint8)
        score = torch.where(i == lp, H.gather(1, lt[:, None])[:, 0], score)

    runs, n_runs = _host_tracebacks(bits, pattern, text, lp, lt)
    return score.to(torch.int32), bits, runs, n_runs


def _host_tracebacks(bits, pattern, text, lp, lt, lo=None):
    """`traceback_runs` of every problem of a batch: (runs, n_runs) as
    tensors on the batch's device."""
    B, P = pattern.shape
    T = text.shape[1]
    bits_host = bits.cpu().numpy()
    pat_host = pattern.cpu().numpy()
    txt_host = text.cpu().numpy()
    lp_host = lp.cpu().tolist()
    lt_host = lt.cpu().tolist()
    lo_host = [None] * B if lo is None else lo.cpu().tolist()
    runs = np.zeros((B, P + T), dtype=np.int32)
    n_runs = np.zeros(B, dtype=np.int32)
    for b in range(B):
        r = traceback_runs(bits_host[b], pat_host[b, :lp_host[b]].tobytes(),
                           txt_host[b, :lt_host[b]].tobytes(), lo_host[b])
        runs[b, :len(r)] = r
        n_runs[b] = len(r)
    return (torch.from_numpy(runs).to(bits.device),
            torch.from_numpy(n_runs).to(bits.device))


def band_geometry(len_p, len_t, band_w):
    """(lo, hi, Wb) of each problem's band: diagonals j - i in [lo, hi],
    Wb = hi - lo + 1 = |T-P| + 2W + 1 lanes. Works on ints and tensors."""
    d = len_t - len_p
    lo = (d - abs(d)) // 2 - band_w           # min(0, d) - W
    hi = (d + abs(d)) // 2 + band_w           # max(0, d) + W
    return lo, hi, hi - lo + 1


def e2e_banded_plain(pattern: torch.Tensor, text: torch.Tensor,
                     len_p: torch.Tensor, len_t: torch.Tensor,
                     band_w: torch.Tensor, width: int, mism: int, gapo: int,
                     gape: int):
    """Plain PyTorch version of the band kernel, on any device.

    pattern (B, P) uint8, text (B, T) uint8, len_p, len_t and band_w (B,),
    `width` the lanes of a bits row, at least every problem's Wb. Rows walk
    the pattern, every band lane k (cell (i, i + lo + k)) at once: D comes
    from lane k+1 of the row before, the diagonal from lane k, and the
    insertion chain along the lanes is a cummin. A neighbour outside the
    band or the matrix gives INF and no extend flag, with the kernel's INF
    and its additions, so every bit of every band cell equals the kernel's.
    The traceback runs on the host over the band bits."""
    B, P = pattern.shape
    T = text.shape[1]
    dev = text.device
    i64 = torch.int64
    go_ge = gapo + gape
    ge = gape
    inf, none = _BAND_INF, _INF
    lp = len_p.to(i64).clamp(0, P)
    lt = len_t.to(i64).clamp(0, T)
    w = band_w.to(i64).clamp(min=0)
    lo, hi, wb = band_geometry(lp, lt, w)
    if B and int(wb.max()) > width:
        raise ValueError(f"banded e2e: a band of {int(wb.max())} lanes "
                         f"exceeds the bits rows' {width}")
    k = torch.arange(width, device=dev, dtype=i64)
    in_band = k[None, :] < wb[:, None]
    up_ok = k[None, :] + 1 < wb[:, None]
    none_col = torch.full((B, 1), none, device=dev, dtype=i64)
    inf_col = torch.full((B, 1), inf, device=dev, dtype=i64)
    txt = text.to(i64)
    pat = pattern.to(i64)

    j = lo[:, None] + k[None, :]
    valid = in_band & (j >= 0) & (j <= lt[:, None])
    H = torch.where(j == 0, 0, gapo + ge * j)
    D = torch.full((B, width), inf, device=dev, dtype=i64)
    bits = torch.zeros((B, P + 1, width), dtype=torch.uint8, device=dev)
    bits0 = torch.where(j == 0, 0, torch.where(j == 1, 2, 2 | 8))
    bits[:, 0, :] = torch.where(valid, bits0, 0).to(torch.uint8)
    k_end = (lt - lp - lo)[:, None]
    score = H.gather(1, k_end)[:, 0]
    for i in range(1, P + 1):
        j = i + lo[:, None] + k[None, :]
        valid = in_band & (j >= 0) & (j <= lt[:, None]) & (i <= lp)[:, None]
        d_open = torch.cat([H[:, 1:], inf_col], dim=1) + go_ge
        d_ext = torch.cat([D[:, 1:], inf_col], dim=1) + ge
        te = (d_ext < d_open) & up_ok
        d_row = torch.where(up_ok, torch.where(te, d_ext, d_open), inf)
        if T:
            tchar = txt.gather(1, (j - 1).clamp(0, T - 1))
        else:
            tchar = torch.zeros_like(j)
        sub = torch.where(tchar == pat[:, i - 1:i], 0, mism)
        diag = torch.where(j >= 1, H + sub, inf)
        td = d_row < diag
        nv = torch.where(td, d_row, diag)
        # I[k] = min over valid k' < k of nv[k'] + go_ge + ge * (k - k' - 1);
        # the first valid lane of a row has no cell to its left
        left_ok = (j >= 1) & (k >= 1)[None, :]
        base = torch.where(valid, nv + go_ge - ge * k - ge, none)
        before = torch.cat([none_col,
                            torch.cummin(base, dim=1).values[:, :-1]], dim=1)
        i_row = torch.where(left_ok, before + ge * k, inf)
        # extend iff the chain before lane k-1 beats opening at k-1
        ext = left_ok & (torch.cat([none_col, before[:, :-1]], dim=1)
                         < torch.cat([none_col, base[:, :-1]], dim=1))
        ti = i_row < nv
        H = torch.where(ti, i_row, nv)
        D = d_row
        cell = torch.where(ti, 2, torch.where(td, 1, 0)) | (te.to(i64) << 2) \
            | ((ext | (j == 0)).to(i64) << 3)
        bits[:, i, :] = torch.where(valid, cell, 0).to(torch.uint8)
        score = torch.where(i == lp, H.gather(1, k_end)[:, 0], score)

    covers = (lo <= -lp) & (hi >= lt)
    certified = covers | (score < gapo + gapo + ge * (2 * w + 2
                                                      + (lt - lp).abs()))
    runs, n_runs = _host_tracebacks(bits, pattern, text, lp, lt, lo)
    return score.to(torch.int32), bits, runs, n_runs, certified


def _check_problem_tensors(what, pattern, text, len_p, len_t, *more):
    dev = text.device
    for name, t, dtype in (("pattern", pattern, torch.uint8),
                           ("text", text, torch.uint8),
                           ("len_p", len_p, torch.int32),
                           ("len_t", len_t, torch.int32)) + more:
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}")
    B = text.shape[0]
    if pattern.dim() != 2 or text.dim() != 2 or pattern.shape[0] != B or \
            any(t.shape != (B,) for t in (len_p, len_t)
                + tuple(t for _n, t, _d in more)):
        raise ValueError(f"{what}: batch sizes disagree")


def _outputs(B, bits_size, n_runs_cols, keep_bits, dev):
    """(bits, score, runs, n_runs) of one launch: bits_size bytes of
    direction bits a problem, in the kernel's own layout. The kernels write
    only what a problem needs; `runs` is handed back whole when keep_bits
    is set, and zeroed for that."""
    if B * bits_size > MAX_BITS_BYTES:
        raise ValueError(f"e2e kernel: {B} problems of {bits_size} bytes of "
                         f"direction bits exceed the {MAX_BITS_BYTES}-byte "
                         f"bound on one launch")
    make = torch.zeros if keep_bits else torch.empty
    return (torch.empty((B, bits_size), dtype=torch.uint8, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            make((B, n_runs_cols), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def _full_bits_size(P: int, T: int, strip: int) -> int:
    """Bytes of the full-matrix kernel's bits of one problem: tiles of 32
    strips, a row of 32 * strip bytes for each of a tile's P + 31 steps."""
    tile = 32 * strip
    return -(-(T + 1) // tile) * (P + 31) * tile


def _band_bits_size(P: int, T: int, half: int) -> int:
    """Bytes of the band kernel's bits of one problem: a row of `half`
    bytes for each of the P + T + 1 anti-diagonals."""
    return (P + T + 1) * half


def _full_bits_rows(flat, P, T, strip, lp, lt):
    """(B, P+1, T+1) bits, 0 outside each problem, from the full-matrix
    kernel's layout (csrc/e2e.cu trgt_e2e_scan); row 0 is not stored."""
    dev = flat.device
    tile = 32 * strip
    i = torch.arange(P + 1, device=dev)[:, None]
    j = torch.arange(T + 1, device=dev)[None, :]
    r = j % tile
    at = ((j // tile) * (P + 31) + (i - 1 + r // strip)) * tile + r
    bits = flat[:, at.clamp(min=0)]
    bits[:, 0, :] = torch.where(j[0] == 0, 0,
                                torch.where(j[0] == 1, 2, 2 | 8))
    inside = (i[None] <= lp[:, None, None]) & (j[None] <= lt[:, None, None])
    return torch.where(inside, bits, 0)


def _band_bits_rows(flat, P, width, half, lp, lt, band_w):
    """(B, P+1, width) bits at [i][k], 0 outside each problem's band and
    matrix, from the band kernel's layout (csrc/e2e.cu trgt_e2e_band)."""
    dev = flat.device
    lo, _hi, wb = band_geometry(lp.long(), lt.long(), band_w.long())
    i = torch.arange(P + 1, device=dev)[:, None]
    k = torch.arange(width, device=dev)[None, :]
    rows = []
    for b in range(flat.shape[0]):       # a problem at a time bounds memory
        j = i + lo[b] + k
        inside = (k < wb[b]) & (j >= 0) & (j <= lt[b]) & (i <= lp[b])
        at = ((i + j) * half + k // 2).clamp(0, flat.shape[1] - 1)
        rows.append(torch.where(inside, flat[b][at], 0))
    return torch.stack(rows)


def _e2e_scan_cuda(pattern, text, len_p, len_t, mism, gapo, gape, keep_bits):
    from ._build import check, get_lib
    _check_problem_tensors("e2e kernel", pattern, text, len_p, len_t)
    dev = text.device
    B, P, T = text.shape[0], pattern.shape[1], text.shape[1]
    lib = get_lib()
    strip = lib.trgt_e2e_strip(T)
    if T + 1 > 32 * strip and 8 * (P + 1) > 227 * 1024:
        raise ValueError(f"e2e kernel: a text of {T} and a pattern of {P} "
                         f"bytes: the tile boundaries of {P} rows do not "
                         f"fit the card's shared memory")
    bits_size = _full_bits_size(P, T, strip)
    flat, score, runs, n_runs = _outputs(B, bits_size, P + T, keep_bits, dev)
    rc = lib.trgt_e2e_scan(
        pattern.data_ptr(), P, text.data_ptr(), T, len_p.data_ptr(),
        len_t.data_ptr(), flat.data_ptr(), bits_size, score.data_ptr(),
        runs.data_ptr(), n_runs.data_ptr(), B, int(mism), int(gapo),
        int(gape), torch.cuda.current_stream(dev).cuda_stream)
    telemetry.add("e2e_full", launches=1)
    check(rc, "e2e kernel launch")
    bits = _full_bits_rows(flat, P, T, strip, len_p.clamp(0, P),
                           len_t.clamp(0, T)) if keep_bits else None
    return score, bits, runs, n_runs


def _e2e_banded_cuda(pattern, text, len_p, len_t, band_w, width, mism, gapo,
                     gape, keep_bits):
    from ._build import check, get_lib
    _check_problem_tensors("banded e2e kernel", pattern, text, len_p, len_t,
                           ("band_w", band_w, torch.int32))
    dev = text.device
    B, P, T = text.shape[0], pattern.shape[1], text.shape[1]
    if not 1 <= width <= MAX_BAND_WIDTH:
        raise ValueError(f"banded e2e kernel: a band of {width} lanes, over "
                         f"its {MAX_BAND_WIDTH}")
    lib = get_lib()
    half = lib.trgt_e2e_band_half(width)
    flat, score, runs, n_runs = _outputs(B, _band_bits_size(P, T, half),
                                         P + T, keep_bits, dev)
    certified = torch.empty((B,), dtype=torch.uint8, device=dev)
    rc = lib.trgt_e2e_band(
        pattern.data_ptr(), P, text.data_ptr(), T, len_p.data_ptr(),
        len_t.data_ptr(), band_w.data_ptr(), flat.data_ptr(), width,
        score.data_ptr(), runs.data_ptr(), n_runs.data_ptr(),
        certified.data_ptr(), B, int(mism), int(gapo), int(gape),
        torch.cuda.current_stream(dev).cuda_stream)
    telemetry.add("e2e_band", launches=1)
    check(rc, "banded e2e kernel launch")
    bits = _band_bits_rows(flat, P, width, half, len_p.clamp(0, P),
                           len_t.clamp(0, T), band_w.clamp(min=0)) \
        if keep_bits else None
    return score, bits, runs, n_runs, certified.bool()


def e2e_scan(pattern: torch.Tensor, text: torch.Tensor,
             len_p: torch.Tensor, len_t: torch.Tensor, mism: int,
             gapo: int, gape: int, keep_bits: bool = True):
    """Full-matrix scan and traceback of tensors already on their device;
    same contract as `e2e_scan_plain`. CPU tensors take the plain version,
    CUDA tensors the kernel, which with keep_bits false skips zeroing its
    outputs and returns None for the bits."""
    if text.device.type == "cpu":
        return e2e_scan_plain(pattern, text, len_p, len_t, mism, gapo, gape)
    if text.device.type == "cuda":
        return _e2e_scan_cuda(pattern, text, len_p, len_t, mism, gapo, gape,
                              keep_bits)
    raise ValueError(f"e2e kernel: unsupported device {text.device}")


def e2e_banded(pattern: torch.Tensor, text: torch.Tensor,
               len_p: torch.Tensor, len_t: torch.Tensor,
               band_w: torch.Tensor, width: int, mism: int, gapo: int,
               gape: int, keep_bits: bool = True):
    """Banded scan and traceback of tensors already on their device; same
    contract as `e2e_banded_plain`, and the same dispatch as `e2e_scan`."""
    if text.device.type == "cpu":
        return e2e_banded_plain(pattern, text, len_p, len_t, band_w, width,
                                mism, gapo, gape)
    if text.device.type == "cuda":
        return _e2e_banded_cuda(pattern, text, len_p, len_t, band_w, width,
                                mism, gapo, gape, keep_bits)
    raise ValueError(f"banded e2e kernel: unsupported device {text.device}")


def encode_problems(problems: Sequence[Tuple[bytes, bytes]]):
    """Raw-byte tokens padded with 0 to the longest of each side:
    pattern (B, P), text (B, T), len_p (B,), len_t (B,) numpy arrays."""
    P = max(len(p) for p, _ in problems)
    T = max(len(t) for _, t in problems)
    p_toks = np.zeros((len(problems), P), dtype=np.uint8)
    t_toks = np.zeros((len(problems), T), dtype=np.uint8)
    for b, (p, t) in enumerate(problems):
        p_toks[b, :len(p)] = np.frombuffer(p, dtype=np.uint8)
        t_toks[b, :len(t)] = np.frombuffer(t, dtype=np.uint8)
    len_p = np.array([len(p) for p, _ in problems], dtype=np.int32)
    len_t = np.array([len(t) for _, t in problems], dtype=np.int32)
    return p_toks, t_toks, len_p, len_t


def _band_fits(len_p: int, len_t: int, band_w: int) -> bool:
    wb = band_geometry(len_p, len_t, band_w)[2]
    return wb <= MAX_BAND_WIDTH and (len_p + 1) * wb <= MAX_BAND_BYTES


def _chunks(groups, row_bytes):
    """The launches of `groups` ({key: [idx]}), each within MAX_BITS_BYTES
    of direction bits at row_bytes(key) a problem."""
    for key, idxs in sorted(groups.items()):
        step = max(1, MAX_BITS_BYTES // row_bytes(key))
        for lo in range(0, len(idxs), step):
            yield key, idxs[lo:lo + step]


def _align_on_host(pattern_texts, idxs, results, mism, gapo, gape, counts):
    t0 = time.perf_counter()
    align = lambda i: align_end_to_end(*pattern_texts[i], mism, gapo, gape)
    if len(idxs) > 1:
        # the host aligner's numpy and native passes release the GIL
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(len(idxs), os.cpu_count() or 2)) as pool:
            host_results = list(pool.map(align, idxs))
    else:
        host_results = [align(i) for i in idxs]
    for idx, r in zip(idxs, host_results):
        results[idx] = r
    counts["host_seconds"] += time.perf_counter() - t0


def e2e_align_batch(pattern_texts: Sequence[Tuple[bytes, bytes]],
                    mism: int, gapo: int, gape: int, device: torch.device):
    """Batched global affine alignment on `device`; returns [(score,
    cigar)] with '='/'X'/'I'/'D' ops ('I' consumes text, 'D' consumes
    pattern), equal to `trgt_tpu.kernels.e2e_device.e2e_align_batch`.
    While a mesh is installed, the problems are cut into one contiguous
    shard per mesh device, and `routed` sums the shards' counts."""
    return mesh.shard_map(
        lambda pts, dev: _e2e_align_batch(pts, mism, gapo, gape, dev),
        device, pattern_texts)


def _e2e_align_batch(pattern_texts, mism, gapo, gape, device):
    counts = Counter()          # this call's share of `routed`
    results = [None] * len(pattern_texts)
    full = {}
    band_w = {}                 # band problems still to certify: idx → W
    host_idxs = []

    def to_host(idx):
        p, t = pattern_texts[idx]
        host_idxs.append(idx)
        counts["host_problems"] += 1
        counts["host_cells"] += (len(p) + 1) * (len(t) + 1)

    for idx, (p, t) in enumerate(pattern_texts):
        cells = (len(p) + 1) * (len(t) + 1)
        if len(p) == 0:
            cig = [(len(t), "I")] if t else []
            results[idx] = ((gapo + gape * len(t)) if t else 0, cig)
            counts["empty_problems"] += 1
        elif len(t) == 0:
            results[idx] = (gapo + gape * len(p), [(len(p), "D")])
            counts["empty_problems"] += 1
        else:
            key = (bucket(len(p)), bucket(len(t)))
            if (key[0] + 1) * (key[1] + 1) <= FULL_MATRIX_CELLS:
                full.setdefault(key, []).append(idx)
                counts["kernel_problems"] += 1
                counts["kernel_cells"] += cells
            elif gape > 0 and _band_fits(len(p), len(t), BAND_W0):
                # the certificate needs gape >= 1
                band_w[idx] = BAND_W0
                counts["band_problems"] += 1
                counts["band_full_cells"] += cells
            else:
                to_host(idx)

    def finish(idx, score, runs):
        results[idx] = (score, decode_runs(runs))

    def on_device(idxs, kind, band_ws=None):
        arrays = encode_problems([pattern_texts[i] for i in idxs])
        telemetry.add(kind, calls=1,
                      cells=telemetry.e2e_cells(*arrays[2:], band_ws),
                      bytes_in=telemetry.e2e_bytes_in(*arrays[2:]))
        return [torch.from_numpy(x).to(device) for x in arrays]

    # every chunk is launched before the first result is read back, and
    # the host-routed problems are aligned while the card works
    launched = []
    for _key, chunk in _chunks(full, lambda k: _full_bits_size(*k, 16)):
        score, _bits, runs, n_runs = e2e_scan(*on_device(chunk, "e2e_full"),
                                              mism, gapo, gape, False)
        launched.append((chunk, score, runs, n_runs))

    while band_w:
        groups = {}
        for idx, w in band_w.items():
            p, t = pattern_texts[idx]
            wb = band_geometry(len(p), len(t), w)[2]
            groups.setdefault((bucket(len(p)), bucket(wb)), []).append(idx)
            counts["band_cells"] += (len(p) + 1) * wb
        passes = []
        # a band problem's text is at most its pattern and its band long
        for (_bp, width), chunk in _chunks(
                groups, lambda k: _band_bits_size(k[0], k[0] + k[1],
                                                  k[1] // 2 + 4)):
            ws = np.array([band_w[i] for i in chunk], dtype=np.int32)
            passes.append((chunk, e2e_banded(
                *on_device(chunk, "e2e_band", ws),
                torch.from_numpy(ws).to(device), width, mism, gapo, gape,
                False)))
        if host_idxs:
            _align_on_host(pattern_texts, host_idxs, results, mism, gapo,
                           gape, counts)
            host_idxs = []
        again = {}
        for chunk, (score, _bits, runs, n_runs, certified) in passes:
            score = score.cpu().tolist()
            certified = certified.cpu().tolist()
            n_runs = n_runs.cpu().tolist()
            telemetry.add("e2e_band",
                          bytes_out=telemetry.e2e_bytes_out(n_runs))
            runs = runs[:, :max(n_runs)].cpu().numpy()
            for b, idx in enumerate(chunk):
                if certified[b]:
                    finish(idx, score[b], runs[b, :n_runs[b]].tolist())
                    continue
                # the failed pass's score bounds the true one from above:
                # the slack that certifies it, as the host aligner jumps
                p, t = pattern_texts[idx]
                need = (score[b] - gapo - gapo) // gape \
                    - abs(len(t) - len(p)) - 2
                w = max(2 * band_w[idx], need // 2 + 1)
                if _band_fits(len(p), len(t), w):
                    again[idx] = w
                    counts["band_relaunches"] += 1
                else:
                    to_host(idx)
        band_w = again

    if host_idxs:
        _align_on_host(pattern_texts, host_idxs, results, mism, gapo, gape,
                       counts)

    for chunk, score, runs, n_runs in launched:
        score = score.cpu().tolist()
        n_runs = n_runs.cpu().tolist()
        telemetry.add("e2e_full", bytes_out=telemetry.e2e_bytes_out(n_runs))
        runs = runs[:, :max(n_runs)].cpu().numpy()
        for b, idx in enumerate(chunk):
            finish(idx, score[b], runs[b, :n_runs[b]].tolist())
    with _ROUTED_LOCK:
        routed.update(counts)
    return results
