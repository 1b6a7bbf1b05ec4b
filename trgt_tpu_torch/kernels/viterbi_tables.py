"""Dense HMM tables for the port's Viterbi: the state carried across calls.

numpy copies of `trgt_tpu/kernels/viterbi.py` `hmm_dense_numpy` (:49),
`_stack_tables` (:100) and `encode_queries` (:290), without the device
mesh (that module imports JAX, so the port cannot import them), plus
`tables_to_torch`, which moves the stacked dict onto an explicit device.

One change from the JAX tables: the edge-rank table R is int16 with
NO_RANK = 0x7FFF for "no edge", where JAX uses uint8 with 255 — a state
with 255 or more in-edges would mis-tie there. Rank tie-breaking is the
same for every topology whose in-degree stays below 255.
"""

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..hmm.model import Hmm
from .bucket import bucket

NEG = -1e30
NO_RANK = 0x7FFF


def hmm_dense_numpy(hmm: Hmm) -> Dict[str, np.ndarray]:
    """Dense tables for one HMM, cached on the instance.

    T[dst, src]: log-prob of the edge src→dst (NEG where absent).
    R[dst, src]: rank of src in dst's edge list (NO_RANK where absent):
    the reference breaks ties first-max-wins over the edge-list order.
    Silent levels stay level by level (never a precomposed closure), as
    in the JAX tables."""
    cached = getattr(hmm, "_torch_np_tables", None)
    if cached is not None:
        return cached
    t = hmm.dense_tables()
    levels = t["silent_levels"]
    S = hmm.num_states
    T = np.full((S, S), NEG, dtype=np.float64)
    R = np.full((S, S), NO_RANK, dtype=np.int16)
    for s in range(S):
        if len(hmm.in_states[s]) >= NO_RANK:
            raise ValueError(f"state {s} has {len(hmm.in_states[s])} "
                             f"in-edges; the rank table holds "
                             f"{NO_RANK - 1}")
        for e, (p, lp) in enumerate(zip(hmm.in_states[s], hmm.in_lps[s])):
            # duplicate src→dst edges: value takes the max, rank the first
            T[s, p] = max(T[s, p], NEG if lp == float("-inf") else lp)
            R[s, p] = min(R[s, p], e)
    level_masks = np.zeros((len(levels), S), dtype=bool)
    for i, level in enumerate(levels):
        level_masks[i, level] = True
    tables = dict(
        T=T.astype(np.float32),
        R=R,
        em=np.where(np.isneginf(t["em"]), NEG, t["em"]).astype(np.float32),
        silent=t["silent"],
        has_edges=t["has_edges"],
        level_masks=level_masks,
        num_levels=len(levels),
    )
    hmm._torch_np_tables = tables
    return tables


def stack_tables(hmms: Sequence[Hmm]) -> Tuple[Dict[str, np.ndarray], int]:
    """Tables deduplicated per HMM instance and padded to the batch maxima:
    per-topology arrays carry a leading U dim, `u_map` (B,) picks a row's
    topology. Returns (tables, num_levels)."""
    uniq: Dict[int, int] = {}
    per = []
    u_map = np.zeros(len(hmms), dtype=np.int32)
    for b, h in enumerate(hmms):
        u = uniq.get(id(h))
        if u is None:
            u = len(per)
            uniq[id(h)] = u
            per.append(hmm_dense_numpy(h))
        u_map[b] = u
    U = len(per)
    S = max(p["em"].shape[0] for p in per)
    n_levels = max(p["num_levels"] for p in per)
    T = np.full((U, S, S), NEG, dtype=np.float32)
    R = np.full((U, S, S), NO_RANK, dtype=np.int16)
    em = np.full((U, S, 5), NEG, dtype=np.float32)
    silent = np.zeros((U, S), dtype=bool)
    has_edges = np.zeros((U, S), dtype=bool)
    level_masks = np.zeros((U, n_levels, S), dtype=bool)
    no_edge_emit = np.zeros((U, S), dtype=bool)
    for u, p in enumerate(per):
        s = p["em"].shape[0]
        T[u, :s, :s] = p["T"]
        R[u, :s, :s] = p["R"]
        em[u, :s] = p["em"]
        silent[u, :s] = p["silent"]
        # padding states are silent with no edges (never valid)
        silent[u, s:] = True
        has_edges[u, :s] = p["has_edges"]
        lm = p["level_masks"]
        level_masks[u, :lm.shape[0], :s] = lm
        no_edge_emit[u, :s] = (~p["has_edges"]) & (~p["silent"])
    return dict(T=T, R=R, em=em, silent=silent, has_edges=has_edges,
                level_masks=level_masks, no_edge_emit=no_edge_emit,
                u_map=u_map), n_levels


_ENC_TABLE = np.zeros(256, dtype=np.int8)
for _i, _c in enumerate(b"#ATCG"):
    _ENC_TABLE[_c] = _i


def encode_queries(queries: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """'#' + q + '#' encoded 0..4 and padded with 0 to the length bucket
    (the grouping key of `viterbi_batch_multi`). Returns (tokens (B, L)
    int8, lengths (B,) int32)."""
    lens = np.array([len(q) + 2 for q in queries], dtype=np.int32)
    L = bucket(int(lens.max()), minimum=64)
    toks = np.zeros((len(queries), L), dtype=np.int8)
    for b, q in enumerate(queries):
        arr = np.frombuffer(("#" + q + "#").encode(), dtype=np.uint8)
        toks[b, :len(arr)] = _ENC_TABLE[arr]
    return toks, lens


def tables_to_torch(tables_np: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The stacked numpy tables as tensors on `device` (same keys and
    dtypes; bool stays bool)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in tables_np.items()}
