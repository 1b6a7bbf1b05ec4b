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
  viterbi_plain        the plain PyTorch version (any device)

Both produce the (L+1, B, K) int16 array of `_viterbi_full`: rows
0..L-1 are per-column traceback segments [entry, silent..., emitting]
padded with -1, row L holds the per-row ok flag; K = num_levels + 1.
"""

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..hmm.model import Hmm
from .bucket import bucket

from .viterbi_tables import (NEG, NO_RANK, encode_queries, stack_tables,
                             tables_to_torch)

# times the CUDA kernel was launched (chip_smoke.py resets and reads it)
launches = 0

# bound on the (L, B, S) uint16 predecessor buffer of one launch
MAX_PRED_BYTES = 1 << 28
# CUDA streams the length groups of one call are spread over
MAX_STREAMS = 32
# states one kernel thread may own (csrc/viterbi.cu kMaxPerThread)
_MAX_PER_THREAD = 4
# shared memory the kernel may take for the column, emissions and tables
_SMEM_LIMIT = 200 * 1024


def viterbi_plain(tokens: torch.Tensor, tables: Dict[str, torch.Tensor],
                  lens: torch.Tensor, ends: torch.Tensor,
                  num_levels: int) -> torch.Tensor:
    """PyTorch port of `_forward` + `_viterbi_full` on any device.

    tokens (B, L) int8; tables from `tables_to_torch`; lens (B,) query
    lengths with the '#' sentinels (0 = empty row); ends (B,) end states.
    Returns (L+1, B, K) int16."""
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
    global launches
    dev = tokens.device
    B, L = tokens.shape
    U, S, _ = tables["T"].shape
    K = num_levels + 1
    if S >= NO_RANK:
        raise ValueError(f"viterbi kernel: {S} states exceed the int16 "
                         f"predecessor encoding")
    threads = min(1024, (S + 31) // 32 * 32)
    if S > threads * _MAX_PER_THREAD:
        raise ValueError(f"viterbi kernel: {S} states exceed "
                         f"{threads * _MAX_PER_THREAD}")
    args = [tokens, lens, ends, tables["u_map"]]
    for name, t, dtype in zip(("tokens", "lens", "ends", "u_map"), args,
                              (torch.int8, torch.int32, torch.int32,
                               torch.int32)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"viterbi kernel: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}")
    # the kernel reads T and R as [src][dst] (conflict-free relax loop)
    Tt = tables["T"].transpose(1, 2).contiguous()
    Rt = tables["R"].transpose(1, 2).contiguous()
    em = tables["em"].contiguous()
    flags = {k: tables[k].contiguous() for k in
             ("silent", "has_edges", "no_edge_emit", "level_masks")}
    # edges into the silent-level states, the most of any topology (int()
    # waits for the current stream only, which holds this batch alone)
    in_levels = tables["level_masks"].any(dim=1)                # (U, S)
    has_edge = tables["R"] < NO_RANK                            # (U, dst, src)
    edge_cap = int((has_edge.sum(dim=2) * in_levels).sum(dim=1).max())
    # column x2, emissions x5, level values, five int arrays of S
    # (csrc/viterbi.cu), the CSR end, level offsets and silent in-edges,
    # then optionally T and R
    smem = 13 * S * 4 + (1 + num_levels + 1 + edge_cap) * 4
    table_bytes = S * S * (4 + 2)
    in_smem = smem + table_bytes <= _SMEM_LIMIT
    if in_smem:
        smem += table_bytes
    pv = torch.empty((L, B, S), dtype=torch.int16, device=dev)
    out = torch.empty((L + 1, B, K), dtype=torch.int16, device=dev)
    lib = get_lib()
    rc = lib.trgt_viterbi(
        tokens.data_ptr(), L, B, lens.data_ptr(), ends.data_ptr(),
        tables["u_map"].data_ptr(), Tt.data_ptr(), Rt.data_ptr(),
        em.data_ptr(), flags["silent"].data_ptr(),
        flags["has_edges"].data_ptr(), flags["no_edge_emit"].data_ptr(),
        flags["level_masks"].data_ptr(), S, num_levels, edge_cap,
        int(in_smem), smem, threads, pv.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
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
                  device: torch.device):
    """Encode one batch of non-empty queries: (tokens, tables, lens,
    ends, num_levels) as tensors on `device`."""
    toks, lens = encode_queries(queries)
    tables_np, num_levels = stack_tables(hmms)
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
    MAX_PRED_BYTES."""
    if len(hmms) != len(queries):
        raise ValueError("hmms and queries differ in length")
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
    # GPU each gets its own stream, so the few-block launches of different
    # length groups run side by side instead of one after another
    streams = ([torch.cuda.Stream(device) for _ in
                range(min(len(batches), MAX_STREAMS))]
               if device.type == "cuda" else [])
    launched = []
    for bi, chunk in enumerate(batches):
        qs = [queries[i] for i in chunk]
        with (torch.cuda.stream(streams[bi % len(streams)]) if streams
              else contextlib.nullcontext()):
            args = prepare_batch([hmms[i] for i in chunk], qs, device)
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
