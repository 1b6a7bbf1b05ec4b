"""Batched ends-free affine flank alignment (the span stage's kernel).

Counterpart of `trgt_tpu.kernels.semiglobal.flank_align_batch_multi`,
whose TPU kernels are `trgt_tpu/kernels/semiglobal_pallas.py`
`_flank_kernel` and `_flank_kernel_seg`. The CUDA kernels
(`csrc/flank.cu`) keep a problem's row state in registers and come in
two classes chosen from the padded text width: widths up to 512 columns
take one warp per problem and four problems per block, wider ones a
block per problem. Every problem has its own text length, so the
segmented packing of short texts has no counterpart of its own.

Layers:
  flank_align_batch_multi  bytes in, [(score, matches, (start, end))] out;
                           groups texts by padded width and chunks them
  flank_align              dispatch on the tensors' device: CPU tensors
                           run `flank_align_plain`, CUDA tensors launch
                           the kernel, anything else raises
  flank_align_plain        the plain PyTorch version (any device)

Semantics (held exactly, see csrc/flank.cu): match 0, mismatch `mism`,
gap open `gapo + gape`, extend `gape`; pattern global, text free at both
ends; ties diag > D > I, open over extend, the later gap-open column
inside a row, the first minimum column at finalize.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import mesh
from . import telemetry
from .bucket import bucket

_INF = 1 << 40
_KEY = 1 << 24          # column index packing for the plain scan
# cells (problems x padded width) per chunk: bounds the plain version's
# temporaries (some twenty int64 arrays of that many cells); the kernel
# keeps its row state in registers and needs no scratch, so for it a chunk
# is only the staged pattern and text bytes
MAX_CHUNK_CELLS = 1 << 22


def flank_align_plain(pattern: torch.Tensor, text: torch.Tensor,
                      lens: torch.Tensor, mism: int, go_ge: int,
                      ge: int) -> torch.Tensor:
    """Plain PyTorch version of the flank kernel, on any device.

    pattern (B, P) uint8 (0 = pad row, skipped); text (B, W) uint8 padded
    with 0; lens (B,) text lengths. Returns (B, 4) int32: score, matches,
    first and last text column of any diagonal step (-1 if none).

    Rows walk the pattern as in `_flank_kernel`; the insertion chain's
    "rightmost argmin of the prefix" is a cummin over keys that pack the
    column index into the low bits, which makes every key unique and the
    result independent of how cummin breaks ties."""
    B, W = text.shape
    if W + 1 >= _KEY:
        raise ValueError(f"text width {W} exceeds the plain version's "
                         f"{_KEY - 2} columns")
    dev = text.device
    i64 = torch.int64
    n = W + 1
    j = torch.arange(n, device=dev, dtype=i64)
    jm1 = (j[1:] - 1).expand(B, W)
    inf_col = torch.full((B, 1), _INF, device=dev, dtype=i64)
    zero_col = torch.zeros((B, 1), device=dev, dtype=i64)
    neg_col = zero_col - 1
    H = torch.zeros((B, n), device=dev, dtype=i64)
    D = torch.full((B, n), _INF, device=dev, dtype=i64)
    MH = torch.zeros_like(H)
    FSH = torch.full_like(H, -1)
    LSH = torch.full_like(H, -1)
    MD = torch.zeros_like(H)
    FSD = torch.full_like(H, -1)
    LSD = torch.full_like(H, -1)
    txt = text.to(i64)
    pat = pattern.to(i64)
    for i in range(pat.shape[1]):
        p = pat[:, i]
        active = (p != 0)[:, None]
        # D: gap in the text, open wins ties over extend
        d_ext = D + ge
        d_open = H + go_ge
        te = d_ext < d_open
        d_row = torch.where(te, d_ext, d_open)
        m_d = torch.where(te, MD, MH)
        fs_d = torch.where(te, FSD, FSH)
        ls_d = torch.where(te, LSD, LSH)
        # diagonal: column j consumes text byte j-1
        match = txt == p[:, None]
        diag = torch.cat([inf_col, H[:, :-1] + torch.where(match, 0, mism)],
                         dim=1)
        m_dg = torch.cat([zero_col, MH[:, :-1] + match.to(i64)], dim=1)
        fs_prev = FSH[:, :-1]
        fs_dg = torch.cat([neg_col, torch.where(fs_prev < 0, jm1, fs_prev)],
                          dim=1)
        ls_dg = torch.cat([neg_col, jm1], dim=1)
        # H without insertions: diagonal wins ties over D
        td = d_row < diag
        nv = torch.where(td, d_row, diag)
        m_n = torch.where(td, m_d, m_dg)
        fs_n = torch.where(td, fs_d, fs_dg)
        ls_n = torch.where(td, ls_d, ls_dg)
        # insertion chain: I[j] = min_{k<j}(nv[k] + go_ge - ge*k - ge)
        # + ge*j, payload of the rightmost argmin
        base = nv + go_ge - ge * j - ge
        cm = torch.cummin(base * _KEY + (_KEY - 1 - j), dim=1).values
        val = torch.div(cm, _KEY, rounding_mode="floor")
        kst = (_KEY - 1) - (cm - val * _KEY)
        i_row = torch.cat([inf_col, val[:, :-1] + ge * j[1:]], dim=1)
        kprev = kst[:, :-1]
        m_i = torch.cat([zero_col, m_n.gather(1, kprev)], dim=1)
        fs_i = torch.cat([neg_col, fs_n.gather(1, kprev)], dim=1)
        ls_i = torch.cat([neg_col, ls_n.gather(1, kprev)], dim=1)
        ti = i_row < nv
        # pad rows (token 0) leave the carry unchanged
        H = torch.where(active, torch.where(ti, i_row, nv), H)
        MH = torch.where(active, torch.where(ti, m_i, m_n), MH)
        FSH = torch.where(active, torch.where(ti, fs_i, fs_n), FSH)
        LSH = torch.where(active, torch.where(ti, ls_i, ls_n), LSH)
        D = torch.where(active, d_row, D)
        MD = torch.where(active, m_d, MD)
        FSD = torch.where(active, fs_d, FSD)
        LSD = torch.where(active, ls_d, LSD)
    # finalize: first minimum over columns j <= len
    masked = torch.where(j[None, :] <= lens.to(i64)[:, None], H, _INF)
    best = masked.min(dim=1).values
    j_end = torch.where(masked == best[:, None], j, n).min(dim=1).values
    pick = lambda A: A.gather(1, j_end[:, None])[:, 0]
    return torch.stack([best, pick(MH), pick(FSH), pick(LSH)],
                       dim=1).to(torch.int32)


def _flank_align_cuda(pattern, text, lens, mism, go_ge, ge):
    from ._build import check, get_lib
    for name, t, dtype in (("pattern", pattern, torch.uint8),
                           ("text", text, torch.uint8),
                           ("lens", lens, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous() or \
                t.device != text.device:
            raise ValueError(f"flank kernel: {name} must be a contiguous "
                             f"{dtype} tensor on {text.device}")
    B = text.shape[0]
    if pattern.shape[0] != B or lens.shape != (B,):
        raise ValueError("flank kernel: batch sizes disagree")
    out = torch.empty((B, 4), dtype=torch.int32, device=text.device)
    lib = get_lib()
    rc = lib.trgt_flank_align(
        pattern.data_ptr(), pattern.shape[1], text.data_ptr(),
        text.shape[1], lens.data_ptr(), out.data_ptr(), B, int(mism),
        int(go_ge), int(ge),
        torch.cuda.current_stream(text.device).cuda_stream)
    telemetry.add("flank", launches=1)
    check(rc, "flank kernel launch")
    return out


def flank_align(pattern: torch.Tensor, text: torch.Tensor,
                lens: torch.Tensor, mism: int, go_ge: int,
                ge: int) -> torch.Tensor:
    """Flank alignment of tensors already on their device; same contract
    as `flank_align_plain`. CPU tensors take the plain version, CUDA
    tensors the kernel, which wants every text shorter than the padded
    width W (a text of len bytes has len + 1 columns; `encode_problems`
    pads so) and traps on a longer one."""
    if text.device.type == "cpu":
        return flank_align_plain(pattern, text, lens, mism, go_ge, ge)
    if text.device.type == "cuda":
        return _flank_align_cuda(pattern, text, lens, mism, go_ge, ge)
    raise ValueError(f"flank kernel: unsupported device {text.device}")


def encode_problems(patterns: Sequence[bytes], texts: Sequence[bytes],
                    width: int) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]:
    """Raw-byte tokens padded with 0 (never a sequence byte): pattern
    (B, max pattern length), text (B, width), lens (B,)."""
    plen = max(len(p) for p in patterns)
    pat = np.zeros((len(patterns), plen), dtype=np.uint8)
    txt = np.zeros((len(texts), width), dtype=np.uint8)
    lens = np.zeros(len(texts), dtype=np.int32)
    for i, (p, t) in enumerate(zip(patterns, texts)):
        pat[i, :len(p)] = np.frombuffer(p, dtype=np.uint8)
        txt[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
        lens[i] = len(t)
    return pat, txt, lens


def decode_results(raw: np.ndarray) -> List[tuple]:
    """(B, 4) kernel output → [(score, matches, (start, end))], with
    (score, 0, (0, 0)) when the alignment has no diagonal step
    (as in `_flank_align_leaf_full`)."""
    out = []
    for score, matches, first, last in raw.tolist():
        if first < 0:
            out.append((float(score), 0, (0, 0)))
        else:
            out.append((float(score), int(matches), (first, last + 1)))
    return out


def flank_align_batch_multi(patterns: Sequence[bytes],
                            seqs: Sequence[bytes], mism: int, gapo: int,
                            gape: int, device: torch.device):
    """Batched ends-free alignment with a per-item pattern on `device`
    (on the mesh's devices while one is installed). Returns [(score,
    n_matches, (text_start, text_end))] in input order, equal to
    `trgt_tpu.kernels.semiglobal.flank_align_batch_multi`."""
    if len(patterns) != len(seqs):
        raise ValueError("patterns and seqs differ in length")
    return mesh.shard_map(
        lambda p, s, dev: _flank_align_batch(p, s, mism, gapo, gape, dev),
        device, patterns, seqs)


def _flank_align_batch(patterns, seqs, mism, gapo, gape, device):
    out: List[tuple] = [None] * len(seqs)
    # group by padded width so short texts do not pad to the longest
    groups = {}
    for i, s in enumerate(seqs):
        groups.setdefault(bucket(len(s) + 1, minimum=64), []).append(i)
    # every chunk is launched before the first result is read back
    launched = []
    for width, idxs in sorted(groups.items()):
        step = max(1, MAX_CHUNK_CELLS // width)
        for lo in range(0, len(idxs), step):
            chunk = idxs[lo:lo + step]
            pat, txt, lens = encode_problems([patterns[i] for i in chunk],
                                             [seqs[i] for i in chunk],
                                             width)
            telemetry.add("flank", calls=1,
                          cells=telemetry.flank_cells(pat, lens),
                          bytes_in=telemetry.nbytes(pat, txt, lens),
                          bytes_out=16 * len(chunk))
            launched.append((chunk, flank_align(
                torch.from_numpy(pat).to(device),
                torch.from_numpy(txt).to(device),
                torch.from_numpy(lens).to(device), mism, gapo + gape,
                gape)))
    for chunk, raw in launched:
        for i, r in zip(chunk, decode_results(raw.cpu().numpy())):
            out[i] = r
    return out
