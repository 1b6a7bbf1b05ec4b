"""Batched unit-cost edit distance (the cluster genotyper's pairwise
distance matrix).

Counterpart of `trgt_tpu.kernels.editdist.edit_distances_batch`, whose
TPU kernel is `trgt_tpu/kernels/editdist_pallas.py` `_edit_kernel`. The
CUDA kernel is `csrc/editdist.cu`: a warp per pair walks the rows of the
short side, the long side in strips of columns across its lanes.

Layers:
  edit_distances_batch  (bytes, bytes) pairs in, [int] out; puts the
                        shorter sequence on the `a` side and groups pairs
                        by the padded width of `b`
  edit_distances        dispatch on the tensors' device: CPU tensors run
                        `edit_distances_plain`, CUDA tensors launch the
                        kernel, anything else raises
  edit_distances_plain  the plain PyTorch version (any device)

The distance is an integer and every version is exact (tolerance 0).
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import mesh
from . import telemetry
from .bucket import bucket

# the cluster genotyper computes exact distances only for pairs with
# len_a * len_b <= MAX_OPS and uses the |length difference| bound above
# (ref: genotype_cluster.rs:231)
MAX_OPS = 10000
# bytes of the short side the kernel takes, four a lane (csrc/editdist.cu
# kMaxA); MAX_OPS bounds the shorter side of a pair to 100
MAX_A = 128
_INF = 1 << 40


def edit_distances_plain(a: torch.Tensor, b: torch.Tensor,
                         len_a: torch.Tensor,
                         len_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the edit-distance kernel, on any device.

    a (B, P) uint8, b (B, W) uint8, len_a and len_b (B,) lengths, clamped
    to the widths. Returns (B,) int32 Levenshtein distances.

    Rows walk `a`, all columns of `b` at once; the left chain
    H[j] = min_k<=j (pre[k] + j - k) is a cummin over pre[k] - k. Rows at
    or beyond a pair's len_a leave its H unchanged, and the result is read
    at column len_b, so the padding never enters a distance."""
    B, P = a.shape
    W = b.shape[1]
    dev = b.device
    i64 = torch.int64
    la = len_a.to(i64).clamp(0, P)
    lb = len_b.to(i64).clamp(0, W)
    j = torch.arange(W + 1, device=dev, dtype=i64)
    H = j.expand(B, W + 1).clone()
    inf_col = torch.full((B, 1), _INF, device=dev, dtype=i64)
    at = a.to(i64)
    bt = b.to(i64)
    for i in range(P):
        active = (i < la)[:, None]
        sub = (bt != at[:, i:i + 1]).to(i64)
        diag = torch.cat([inf_col, H[:, :-1] + sub], dim=1)
        pre = torch.minimum(diag, H + 1)
        H_row = torch.cummin(pre - j, dim=1).values + j
        H = torch.where(active, H_row, H)
    return H.gather(1, lb[:, None])[:, 0].to(torch.int32)


def _edit_distances_cuda(a, b, len_a, len_b):
    from ._build import check, get_lib
    dev = b.device
    for name, t, dtype in (("a", a, torch.uint8), ("b", b, torch.uint8),
                           ("len_a", len_a, torch.int32),
                           ("len_b", len_b, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"edit-distance kernel: {name} must be a "
                             f"contiguous {dtype} tensor on {dev}")
    B = b.shape[0]
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != B or \
            len_a.shape != (B,) or len_b.shape != (B,):
        raise ValueError("edit-distance kernel: batch sizes disagree")
    if a.shape[1] > MAX_A:
        raise ValueError(f"edit-distance kernel: `a` is {a.shape[1]} wide, "
                         f"over its {MAX_A} rows; put the shorter sequence "
                         f"of each pair on the `a` side")
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    rc = get_lib().trgt_edit_distances(
        a.data_ptr(), a.shape[1], b.data_ptr(), b.shape[1],
        len_a.data_ptr(), len_b.data_ptr(), out.data_ptr(), B,
        torch.cuda.current_stream(dev).cuda_stream)
    telemetry.add("editdist", launches=1)
    check(rc, "edit-distance kernel launch")
    return out


def edit_distances(a: torch.Tensor, b: torch.Tensor, len_a: torch.Tensor,
                   len_b: torch.Tensor) -> torch.Tensor:
    """Edit distances of tensors already on their device; same contract
    as `edit_distances_plain`, with `a` at most MAX_A wide on a GPU. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if b.device.type == "cpu":
        return edit_distances_plain(a, b, len_a, len_b)
    if b.device.type == "cuda":
        return _edit_distances_cuda(a, b, len_a, len_b)
    raise ValueError(f"edit-distance kernel: unsupported device {b.device}")


def encode_pairs(pairs: Sequence[Tuple[bytes, bytes]], width: int):
    """Raw-byte tokens padded with 0: a (B, longest a), b (B, width),
    len_a (B,), len_b (B,) as numpy arrays."""
    a_w = max(1, max(len(a) for a, _ in pairs))
    a_toks = np.zeros((len(pairs), a_w), dtype=np.uint8)
    b_toks = np.zeros((len(pairs), width), dtype=np.uint8)
    for i, (a, b) in enumerate(pairs):
        a_toks[i, :len(a)] = np.frombuffer(a, dtype=np.uint8)
        b_toks[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    len_a = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    len_b = np.array([len(b) for _, b in pairs], dtype=np.int32)
    return a_toks, b_toks, len_a, len_b


def edit_distances_batch(pairs: Sequence[Tuple[bytes, bytes]],
                         device: torch.device) -> List[int]:
    """Exact edit distances for a list of (bytes, bytes) pairs on
    `device`, equal to `trgt_tpu.kernels.editdist.edit_distances_batch`.

    The shorter sequence of each pair goes on the `a` side (the distance
    is symmetric); pairs are grouped by the padded width of `b`, so one
    1 x 10000 pair does not pad thousands of short ones to its width.
    While a mesh is installed, the pairs are cut into one contiguous shard
    per mesh device."""
    return mesh.shard_map(_edit_distances_batch, device, pairs)


def _edit_distances_batch(pairs, device):
    out: List[int] = [0] * len(pairs)
    groups = {}
    norm = []
    for i, (a, b) in enumerate(pairs):
        if len(a) > len(b):
            a, b = b, a
        if len(a) > MAX_A:
            raise ValueError(f"edit-distance pair {i}: both sequences are "
                             f"over {MAX_A} long")
        norm.append((a, b))
        groups.setdefault(bucket(len(b), minimum=128), []).append(i)
    # every group is launched before the first result is read back
    launched = []
    for width, idxs in sorted(groups.items()):
        arrays = encode_pairs([norm[i] for i in idxs], width)
        telemetry.add("editdist", calls=1,
                      cells=telemetry.editdist_cells(*arrays[2:]),
                      bytes_in=telemetry.nbytes(*arrays),
                      bytes_out=4 * len(idxs))
        launched.append((idxs, edit_distances(
            *(torch.from_numpy(x).to(device) for x in arrays))))
    for idxs, dist in launched:
        for i, d in zip(idxs, dist.cpu().tolist()):
            out[i] = d
    return out
