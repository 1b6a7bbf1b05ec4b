"""Batched HMM Viterbi with traceback (the annotate stage's kernel).

Counterpart of `trgt_tpu.kernels.viterbi.viterbi_batch_multi`, whose
device code is the XLA scan `_viterbi_full` / `_forward`. The CUDA
kernel is `csrc/viterbi.cu`.

Layers:
  viterbi_batch_multi  HMMs + query strings in, state paths out; the same
                       (L, S) bucket grouping and host assembly as JAX
  viterbi_segs         dispatch on the tensors' device: CPU tensors run
                       `viterbi_plain`, CUDA tensors launch the kernel,
                       anything else raises
  viterbi_plain        the plain PyTorch version (any device), a dense
                       relax over (U, S, S) tables

The kernel relaxes over in-edge lists instead: `prepare_batch` gives a
CUDA device the sparse tables of `viterbi_tables.stack_sparse_tables`
(built once per `Hmm` on the host), which are a few kilobytes where the
dense ones are S x S per topology. `viterbi_plain` takes the dense ones
only, which `stack_tables` builds from the HMMs' edge lists on their own:
`prepare_batch(..., sparse=False)` gives them on any device, so a check
of the kernel against the plain version also checks the sparse tables.

Both produce the (L+1, B, K) int16 array of `_viterbi_full`: rows
0..L-1 are per-column traceback segments [entry, silent..., emitting]
padded with -1, row L holds the per-row ok flag; K = num_levels + 1.
"""

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import mesh
from ..hmm.model import Hmm
from . import telemetry
from .bucket import bucket

from .viterbi_tables import (NEG, NO_RANK, encode_queries,
                             stack_sparse_tables, stack_tables,
                             tables_to_torch)

# bound on the (L, B, S) uint16 predecessor buffer of one launch
MAX_PRED_BYTES = 1 << 28
# CUDA streams the length groups of one call are spread over
MAX_STREAMS = 32
# batch rows (one warp each) a block of the kernel holds at most
_MAX_WARPS = 4
# states a predecessor word of the kernel can name (14 bits)
_MAX_STATES = (1 << 14) - 1
# positions whose words the kernel's traceback stages at a time
_TRACEBACK_CHUNK = 32
# shared memory a block of the kernel may take
_SMEM_LIMIT = 200 * 1024


def viterbi_plain(tokens: torch.Tensor, tables: Dict[str, torch.Tensor],
                  lens: torch.Tensor, ends: torch.Tensor,
                  num_levels: int) -> torch.Tensor:
    """PyTorch port of `_forward` + `_viterbi_full` on any device.

    tokens (B, L) int8; tables from `stack_tables` through
    `tables_to_torch`; lens (B,) query lengths with the '#' sentinels
    (0 = empty row); ends (B,) end states. Returns (L+1, B, K) int16."""
    u = tables["u_map"].long()
    T = tables["T"][u]                                  # (B, S, S)
    R = tables["R"][u].long()
    em = tables["em"][u]                                # (B, S, 5)
    silent = tables["silent"][u]
    has_edges = tables["has_edges"][u]
    level_masks = tables["level_masks"][u]
    no_edge_emit = tables["no_edge_emit"][u]
    B, L = tokens.shape
    S = em.shape[1]
    K = num_levels + 1
    dev = tokens.device
    src = torch.arange(S, device=dev)
    # (rank, src) packed into one key: the argmin is unique, and equals
    # the first source of minimum rank
    rank_key = R * S + src
    no_rank_key = NO_RANK * S + src
    toks = tokens.long()

    def relax(col):
        cand = col[:, None, :] + T
        best = cand.max(dim=2).values
        tie = cand >= best[:, :, None]
        pred = torch.where(tie, rank_key, no_rank_key).argmin(dim=2)
        return best, pred

    def em_at(sym):
        return em.gather(2, sym[:, None, None].expand(B, S, 1))[:, :, 0]

    def resolve_silent(col, pred, valid):
        for li in range(num_levels):
            mask = level_masks[:, li, :]
            best, p = relax(col)
            newv = best > NEG / 2
            col = torch.where(mask, torch.where(newv, best, NEG), col)
            pred = torch.where(mask & newv, p, pred)
            valid = torch.where(mask, newv, valid)
        return col, pred, valid

    em0 = em_at(toks[:, 0])
    col = torch.where(no_edge_emit, em0, NEG)
    pred = src[None, :].expand(B, S)
    valid = no_edge_emit & (col > NEG / 2)
    col, pred, valid = resolve_silent(col, pred, valid)
    preds = [pred]
    valids = [valid]
    for t in range(1, L):
        best, pred = relax(col)
        col = torch.where(silent, NEG, best + em_at(toks[:, t]))
        valid = (~silent) & has_edges & (col > NEG / 2)
        col = torch.where(valid, col, NEG)
        col, pred, valid = resolve_silent(col, pred, valid)
        preds.append(pred)
        valids.append(valid)
    preds = torch.stack(preds)                          # (L, B, S)
    valids = torch.stack(valids)

    # traceback (`back_step`), reverse over positions
    rows = torch.arange(B, device=dev)
    lens = lens.long()
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    active = torch.zeros(B, dtype=torch.bool, device=dev)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    segs = torch.empty((L + 1, B, K), dtype=torch.int16, device=dev)
    for t in range(L - 1, -1, -1):
        start_here = lens - 1 == t
        cur = torch.where(start_here, ends.long(), cur)
        active = active | start_here
        s = cur
        alive = active
        next_cur = cur
        for k in range(K):
            pred_s = preds[t, rows, s]
            valid_s = valids[t, rows, s]
            sil_s = silent[rows, s]
            segs[t, :, k] = torch.where(alive, s, -1)
            ok = ok & (~alive | valid_s)
            next_cur = torch.where(alive & ~sil_s, pred_s, next_cur)
            alive = alive & sil_s
            s = torch.where(alive, pred_s, s)
        ok = ok & ~alive
        cur = next_cur
    segs[L] = ok[:, None].to(torch.int16)
    return segs


def _viterbi_cuda(tokens, tables, lens, ends, num_levels):
    from ._build import check, get_lib
    dev = tokens.device
    B, L = tokens.shape
    if "e_off" not in tables:
        raise ValueError("viterbi kernel: needs the sparse tables of "
                         "stack_sparse_tables")
    S = tables["e_off"].shape[1] - 1
    E = tables["e_src"].shape[1]
    NS = tables["sched"].shape[1]
    P = tables["ph_off"].shape[1] - 1
    K = num_levels + 1
    if S > _MAX_STATES:
        raise ValueError(f"viterbi kernel: {S} states exceed the "
                         f"{_MAX_STATES} a predecessor word holds")
    lib = get_lib()
    # a row's slice of shared memory: two columns, emissions, the 4-wide
    # edge tables by state and by schedule slot, the phases, flags, the
    # position's words, and two chunks of positions' words for the
    # traceback: the longest chunk that leaves room for the rest
    chunk = _TRACEBACK_CHUNK
    per_warp = lib.trgt_viterbi_slice_bytes(S, NS, P, chunk)
    while per_warp > _SMEM_LIMIT and chunk > 1:
        chunk //= 2
        per_warp = lib.trgt_viterbi_slice_bytes(S, NS, P, chunk)
    if per_warp > _SMEM_LIMIT:
        raise ValueError(f"viterbi kernel: {S} states need {per_warp} bytes "
                         f"of shared memory a row, over the {_SMEM_LIMIT} "
                         f"a block may take")
    warps = min(_MAX_WARPS, _SMEM_LIMIT // per_warp)
    kinds = dict(tokens=torch.int8, lens=torch.int32, ends=torch.int32,
                 u_map=torch.int32, e_off=torch.int32, e_src=torch.int16,
                 e_lp=torch.float32, em=torch.float32, silent=torch.bool,
                 has_edges=torch.bool, no_edge_emit=torch.bool,
                 sched=torch.int16, sl_link=torch.int16,
                 sl_edge=torch.int16, ph_off=torch.int16,
                 ph_depth=torch.int16)
    named = dict(tables, tokens=tokens, lens=lens, ends=ends)
    for name, dtype in kinds.items():
        t = named[name]
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"viterbi kernel: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}")
    # predecessor words, a row's positions side by side, each position's
    # words padded to 16 bytes
    pv = torch.empty((B, L, (S + 7) // 8 * 8), dtype=torch.int16, device=dev)
    out = torch.empty((L + 1, B, K), dtype=torch.int16, device=dev)
    ptr = lambda name: named[name].data_ptr()
    rc = lib.trgt_viterbi(
        ptr("tokens"), L, B, ptr("lens"), ptr("ends"), ptr("u_map"),
        ptr("e_off"), ptr("e_src"), ptr("e_lp"), E, ptr("em"),
        ptr("silent"), ptr("has_edges"), ptr("no_edge_emit"), ptr("sched"),
        ptr("sl_link"), ptr("sl_edge"), ptr("ph_off"), ptr("ph_depth"), NS,
        P, S, K, chunk, warps, per_warp, pv.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    telemetry.add("viterbi", launches=1)
    check(rc, "viterbi kernel launch")
    return out


def viterbi_segs(tokens: torch.Tensor, tables: Dict[str, torch.Tensor],
                 lens: torch.Tensor, ends: torch.Tensor,
                 num_levels: int) -> torch.Tensor:
    """Viterbi segments of tensors already on their device; same contract
    as `viterbi_plain`. CPU tensors take the plain version, CUDA tensors
    the kernel."""
    if tokens.device.type == "cpu":
        return viterbi_plain(tokens, tables, lens, ends, num_levels)
    if tokens.device.type == "cuda":
        return _viterbi_cuda(tokens, tables, lens, ends, num_levels)
    raise ValueError(f"viterbi kernel: unsupported device {tokens.device}")


def prepare_batch(hmms: Sequence[Hmm], queries: Sequence[str],
                  device: torch.device, sparse: Optional[bool] = None):
    """Encode one batch of non-empty queries: (tokens, tables, lens,
    ends, num_levels) as tensors on `device`. A CUDA device gets the
    sparse tables the kernel reads, any other the dense ones of
    `viterbi_plain`; `sparse` overrides that choice."""
    toks, lens = encode_queries(queries)
    if sparse is None:
        sparse = device.type == "cuda"
    stack = stack_sparse_tables if sparse else stack_tables
    tables_np, num_levels = stack(hmms)
    ends = np.array([h.num_states - 1 for h in hmms], dtype=np.int32)
    to = lambda a: torch.from_numpy(a).to(device)
    return (to(toks), tables_to_torch(tables_np, device), to(lens),
            to(ends), num_levels)


def viterbi_batch_multi(hmms: Sequence[Hmm], queries: Sequence[str],
                        device: torch.device) -> List[List[int]]:
    """[hmms[i].label(queries[i])] on `device`; hmms may differ.

    Requests are grouped by (query-length bucket, state-count bucket) as in
    the JAX version, so one 10 kb allele does not pad short queries to its
    length, and each group is cut so its predecessor buffer stays under
    MAX_PRED_BYTES. While a mesh is installed, the requests are cut into
    one contiguous shard per mesh device."""
    if len(hmms) != len(queries):
        raise ValueError("hmms and queries differ in length")
    return mesh.shard_map(_viterbi_batch, device, hmms, queries)


def _viterbi_batch(hmms, queries, device):
    groups: Dict[tuple, List[int]] = {}
    for i, (h, q) in enumerate(zip(hmms, queries)):
        if q:
            key = (bucket(len(q) + 2, minimum=64),
                   bucket(h.num_states, minimum=32))
            groups.setdefault(key, []).append(i)
    batches = []
    for (L, S), idxs in sorted(groups.items()):
        step = max(1, MAX_PRED_BYTES // (2 * L * S))
        batches.extend(idxs[lo:lo + step] for lo in range(0, len(idxs), step))
    # every batch is launched before the first result is read back; on a
    # GPU each gets its own stream: a launch lasts as long as its longest
    # query (the position loop is serial) and fills a few SMs, so the
    # length groups run side by side instead of one after another (the
    # targeted bench run's calls replayed: 219-291 ms with streams, 388-606
    # ms on one stream, NVIDIA H100 80GB HBM3, 700 W; chip_profile.py
    # streams)
    streams = ([torch.cuda.Stream(device) for _ in
                range(min(len(batches), MAX_STREAMS))]
               if device.type == "cuda" else [])
    launched = []
    for bi, chunk in enumerate(batches):
        qs = [queries[i] for i in chunk]
        hs = [hmms[i] for i in chunk]
        with (torch.cuda.stream(streams[bi % len(streams)]) if streams
              else contextlib.nullcontext()):
            args = prepare_batch(hs, qs, device)
            B, L = args[0].shape
            telemetry.add("viterbi", calls=1,
                          cells=telemetry.viterbi_cells(hs, qs),
                          bytes_in=telemetry.nbytes(*args[:4]),
                          bytes_out=2 * (L + 1) * B * (args[4] + 1))
            launched.append((chunk, [len(q) + 2 for q in qs],
                             viterbi_segs(*args)))
    if streams:
        torch.cuda.synchronize(device)
    out: List[List[int]] = [[] for _ in queries]
    for chunk, lens, segs_ok in launched:
        segs_ok = segs_ok.cpu().numpy()
        Lp = segs_ok.shape[0] - 1
        segs, oks = segs_ok[:Lp], segs_ok[Lp, :, 0] != 0
        for b, i in enumerate(chunk):
            if not oks[b]:
                raise ValueError("HMM traceback failed (no valid path)")
            seg = segs[:lens[b], b, ::-1].reshape(-1)
            out[i] = seg[seg >= 0].tolist()
    return out
