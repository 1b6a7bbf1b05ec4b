"""Batched end-to-end affine alignment with CIGAR (consensus repair).

Counterpart of `trgt_tpu.kernels.e2e_device.e2e_align_batch`, whose
device code is the XLA scan `_e2e_scan` followed by the host
`_traceback`. The CUDA kernel is `csrc/e2e.cu`; it does the scan and the
traceback in one launch.

Layers:
  e2e_align_batch  (pattern, text) byte pairs in, [(score, cigar)] out;
                   the reference's routing: an empty side is answered on
                   the host, problems over MAX_DEVICE_CELLS bucketed cells
                   go to `align_host.align_end_to_end`, the rest to the
                   kernel, grouped by length bucket
  e2e_scan         dispatch on the tensors' device: CPU tensors run
                   `e2e_scan_plain`, CUDA tensors launch the kernel,
                   anything else raises
  e2e_scan_plain   the plain PyTorch version (any device): the row scan in
                   tensor ops, then `traceback_runs` on the host

Both return (score, bits, runs, n_runs):
  score  (B,) int32           H[len_p, len_t]
  bits   (B, P+1, T+1) uint8  per cell: choice (0 diag, 1 D, 2 I) |
                              D-extend << 2 | I-extend << 3; 0 outside
                              rows <= len_p, columns <= len_t
  runs   (B, P+T) int32       run-length CIGAR ops, length << 2 | op
                              (0 '=', 1 'X', 2 'D', 3 'I'), the
                              alignment's LAST run first; 0 past n_runs
  n_runs (B,) int32

Tie rules (held exactly, see csrc/e2e.cu): diagonal over D over I, gap
open over extend, and an insertion run opens at the latest optimal
column. CIGARs are byte-identical to `align_host.align_end_to_end`.

Where the traceback runs: on the card, by thread 0 of the block that
scanned the problem. The alternative, fetching the bits and walking them
on the host as the reference does, moves (P+1)(T+1) bytes per problem
over PCIe and then pays a Python loop of P+T steps.
"""

import os
import time
from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .align_host import align_end_to_end
from .bucket import bucket

# times the CUDA kernel was launched (chip_smoke.py resets and reads it)
launches = 0
# problems and DP cells ((len_p + 1) * (len_t + 1)) that e2e_align_batch
# sent each way: kernel_*, host_* (over MAX_DEVICE_CELLS), empty_problems;
# host_seconds is the wall time its host-routed alignments took
routed: Counter = Counter()

CigarOps = List[Tuple[int, str]]

# a problem whose bucketed (P+1) * (T+1) exceeds this goes to the host
# aligner, as in the reference
MAX_DEVICE_CELLS = 1 << 20
# bound on the direction-bit array of one launch (one byte per cell):
# 1 GiB of the card's 80 GB, at least 1024 problems of the largest size
MAX_BITS_BYTES = 1 << 30

_INF = 1 << 40
_KEY = 1 << 21          # column index packing for the plain scan
_OPS = "=XDI"


def traceback_runs(bits: np.ndarray, pattern: bytes,
                   text: bytes) -> List[int]:
    """The reference's `_traceback` over one problem's (rows, columns)
    bits, returning encoded runs (length << 2 | op), last run first."""
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
        b = int(bits[i, j])
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
                b = int(bits[i, j])
                emit(2)
                ext = bool(b & 4)
                i -= 1
        else:
            emit(3)
            ext = bool(b & 8)
            j -= 1
            while ext and j > 0:
                b = int(bits[i, j])
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

    bits_host = bits.cpu().numpy()
    pat_host = pattern.cpu().numpy()
    txt_host = text.cpu().numpy()
    lp_host = lp.cpu().tolist()
    lt_host = lt.cpu().tolist()
    runs = np.zeros((B, P + T), dtype=np.int32)
    n_runs = np.zeros(B, dtype=np.int32)
    for b in range(B):
        r = traceback_runs(bits_host[b], pat_host[b, :lp_host[b]].tobytes(),
                           txt_host[b, :lt_host[b]].tobytes())
        runs[b, :len(r)] = r
        n_runs[b] = len(r)
    return (score.to(torch.int32), bits, torch.from_numpy(runs).to(dev),
            torch.from_numpy(n_runs).to(dev))


def _e2e_scan_cuda(pattern, text, len_p, len_t, mism, gapo, gape):
    from ._build import check, get_lib
    global launches
    dev = text.device
    for name, t, dtype in (("pattern", pattern, torch.uint8),
                           ("text", text, torch.uint8),
                           ("len_p", len_p, torch.int32),
                           ("len_t", len_t, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"e2e kernel: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}")
    B = text.shape[0]
    if pattern.dim() != 2 or text.dim() != 2 or pattern.shape[0] != B or \
            len_p.shape != (B,) or len_t.shape != (B,):
        raise ValueError("e2e kernel: batch sizes disagree")
    P, T = pattern.shape[1], text.shape[1]
    if B * (P + 1) * (T + 1) > MAX_BITS_BYTES:
        raise ValueError(f"e2e kernel: {B} problems of ({P}+1)x({T}+1) "
                         f"cells exceed the {MAX_BITS_BYTES}-byte bound on "
                         f"one launch's direction bits")
    scratch = torch.empty((max(B, 1) * (T + 1), 2), dtype=torch.int32,
                          device=dev)
    bits = torch.zeros((B, P + 1, T + 1), dtype=torch.uint8, device=dev)
    score = torch.empty((B,), dtype=torch.int32, device=dev)
    runs = torch.zeros((B, P + T), dtype=torch.int32, device=dev)
    n_runs = torch.empty((B,), dtype=torch.int32, device=dev)
    rc = get_lib().trgt_e2e_scan(
        pattern.data_ptr(), P, text.data_ptr(), T, len_p.data_ptr(),
        len_t.data_ptr(), scratch.data_ptr(), bits.data_ptr(),
        score.data_ptr(), runs.data_ptr(), n_runs.data_ptr(), B, int(mism),
        int(gapo), int(gape), torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    check(rc, "e2e kernel launch")
    return score, bits, runs, n_runs


def e2e_scan(pattern: torch.Tensor, text: torch.Tensor,
             len_p: torch.Tensor, len_t: torch.Tensor, mism: int,
             gapo: int, gape: int):
    """Scan and traceback of tensors already on their device; same
    contract as `e2e_scan_plain`. CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if text.device.type == "cpu":
        return e2e_scan_plain(pattern, text, len_p, len_t, mism, gapo, gape)
    if text.device.type == "cuda":
        return _e2e_scan_cuda(pattern, text, len_p, len_t, mism, gapo, gape)
    raise ValueError(f"e2e kernel: unsupported device {text.device}")


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


def _cigar_cost(cigar: CigarOps, mism: int, gapo: int, gape: int) -> int:
    cost = 0
    for length, op in cigar:
        if op == "X":
            cost += mism * length
        elif op in "ID":
            cost += gapo + gape * length
    return cost


def e2e_align_batch(pattern_texts: Sequence[Tuple[bytes, bytes]],
                    mism: int, gapo: int, gape: int, device: torch.device):
    """Batched global affine alignment on `device`; returns [(score,
    cigar)] with '='/'X'/'I'/'D' ops ('I' consumes text, 'D' consumes
    pattern), equal to `trgt_tpu.kernels.e2e_device.e2e_align_batch`."""
    results = [None] * len(pattern_texts)
    groups = {}
    host_idxs = []
    for idx, (p, t) in enumerate(pattern_texts):
        cells = (len(p) + 1) * (len(t) + 1)
        if len(p) == 0:
            cig = [(len(t), "I")] if t else []
            results[idx] = ((gapo + gape * len(t)) if t else 0, cig)
            routed["empty_problems"] += 1
        elif len(t) == 0:
            results[idx] = (gapo + gape * len(p), [(len(p), "D")])
            routed["empty_problems"] += 1
        else:
            key = (bucket(len(p)), bucket(len(t)))
            if (key[0] + 1) * (key[1] + 1) > MAX_DEVICE_CELLS:
                host_idxs.append(idx)
                routed["host_problems"] += 1
                routed["host_cells"] += cells
            else:
                groups.setdefault(key, []).append(idx)
                routed["kernel_problems"] += 1
                routed["kernel_cells"] += cells

    # every chunk is launched before the first result is read back, and
    # the host-routed problems are aligned while the card works
    launched = []
    for (bP, bT), idxs in sorted(groups.items()):
        step = max(1, MAX_BITS_BYTES // ((bP + 1) * (bT + 1)))
        for lo in range(0, len(idxs), step):
            chunk = idxs[lo:lo + step]
            arrays = encode_problems([pattern_texts[i] for i in chunk])
            _score, _bits, runs, n_runs = e2e_scan(
                *(torch.from_numpy(x).to(device) for x in arrays), mism,
                gapo, gape)
            launched.append((chunk, runs, n_runs))

    if host_idxs:
        t0 = time.perf_counter()
        align = lambda i: align_end_to_end(*pattern_texts[i], mism, gapo,
                                           gape)
        if len(host_idxs) > 1:
            # the host aligner's numpy and native passes release the GIL
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(min(len(host_idxs),
                                        os.cpu_count() or 2)) as pool:
                host_results = list(pool.map(align, host_idxs))
        else:
            host_results = [align(host_idxs[0])]
        for idx, r in zip(host_idxs, host_results):
            results[idx] = r
        routed["host_seconds"] += time.perf_counter() - t0

    for chunk, runs, n_runs in launched:
        runs = runs.cpu().numpy()
        n_runs = n_runs.cpu().tolist()
        for b, idx in enumerate(chunk):
            cigar = decode_runs(runs[b, :n_runs[b]].tolist())
            results[idx] = (_cigar_cost(cigar, mism, gapo, gape), cigar)
    return results
