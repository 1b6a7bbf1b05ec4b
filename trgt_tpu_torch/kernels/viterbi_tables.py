"""HMM tables for the port's Viterbi: the state carried across calls.

numpy copies of `trgt_tpu/kernels/viterbi.py` `hmm_dense_numpy` (:49),
`_stack_tables` (:100) and `encode_queries` (:290), without the device
mesh (that module imports JAX, so the port cannot import them), plus
`tables_to_torch`, which moves the stacked dict onto an explicit device.

One change from the JAX tables: the edge-rank table R is int16 with
NO_RANK = 0x7FFF for "no edge", where JAX uses uint8 with 255 — a state
with 255 or more in-edges would mis-tie there. Rank tie-breaking is the
same for every topology whose in-degree stays below 255.

Beside the dense tables (the input of `viterbi_plain` and of the tests)
stand the sparse ones the CUDA kernel reads (`hmm_sparse_numpy`,
`stack_sparse_tables`): in build_hmm's topologies a state has at most
four in-edges (the run-end state one per motif), so the kernel relaxes
over in-edge lists instead of S x S tables. They are built once per
`Hmm` on the host and cached on the instance:
  e_off/e_src/e_lp  CSR of every state's in-edges in edge-list (rank)
                    order, duplicates merged as the dense tables merge
                    them (max value, first rank); a zero-probability
                    edge keeps its place with the value NEG
  lv_states/lv_off  the silent states in level order (per `Hmm` only:
                    what the schedule below is made from and held against;
                    the kernel does not read them, so they are not stacked)
  sched, sl_link,   the same silent states as a schedule of phases of at
  sl_edge, ph_off,  most 32 states, one per lane of a warp. Inside a phase a
  ph_depth          state reads at most one state of the same phase (its
                    chain source, `sl_link`: that state's lane and this
                    state's step, one more than its source's); every other
                    silent source lies in an earlier phase. The kernel
                    relaxes a phase's states side by side over their final
                    sources, then hands the chain values from lane to
                    lane, step by step: a motif's delete chain costs a
                    shuffle and an add per link instead of a barrier per
                    level. Every state is still relaxed once, over final
                    sources and in rank order (`sl_edge` is the chain
                    edge's place in the list), so values and ties are
                    those of the level-by-level relax.
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


LANES = 32


def _schedule(hmm: Hmm, levels, e_off: np.ndarray, e_src: np.ndarray):
    """(sched, sl_link, sl_edge, ph_off, ph_depth) for one HMM.

    Phase p holds the slots ph_off[p] .. ph_off[p+1] of `sched` (at most
    LANES states; slot minus ph_off[p] is the state's lane) and takes
    ph_depth[p] steps. sl_link = step << 6 | (chain source's lane + 1), 0
    in the low bits for a state without chain source; sl_edge is the chain
    source's place in the state's in-edge list, -1 without one.

    Greedy over the states in level order: a state whose latest silent
    sources are one state of phase p joins phase p one step after it; with
    several such sources, or none, it starts at step 0 of the next phase
    (of phase 0 without silent sources). A full phase passes the state on
    to the next one with room, where all its sources are earlier phases."""
    silent = {s for level in levels for s in level}
    phase_of: Dict[int, int] = {}
    step_of: Dict[int, int] = {}
    chain_of: Dict[int, int] = {}
    phases: list = []                           # phases[p] = [states]
    for level in levels:
        for s in level:
            srcs = {p for p in hmm.in_states[s] if p in silent}
            if any(p not in phase_of for p in srcs):
                raise ValueError(f"silent state {s} reads a silent state "
                                 f"of no earlier level")
            ph, chain = 0, -1
            if srcs:
                ph = max(phase_of[p] for p in srcs)
                tops = [p for p in srcs if phase_of[p] == ph]
                if len(tops) == 1 and len(phases[ph]) < LANES:
                    chain = tops[0]
                else:
                    ph += 1
            while ph < len(phases) and len(phases[ph]) >= LANES:
                ph += 1
                chain = -1
            while len(phases) <= ph:
                phases.append([])
            phases[ph].append(s)
            phase_of[s], chain_of[s] = ph, chain
            step_of[s] = step_of[chain] + 1 if chain >= 0 else 0
    sched, link, edge, ph_off, ph_depth = [], [], [], [0], []
    for states in phases:
        lane_of = {s: lane for lane, s in enumerate(states)}
        for s in states:
            chain = chain_of[s]
            sched.append(s)
            link.append(step_of[s] << 6
                        | (lane_of[chain] + 1 if chain >= 0 else 0))
            edges = e_src[e_off[s]:e_off[s + 1]].tolist()
            edge.append(edges.index(chain) if chain >= 0 else -1)
        ph_off.append(len(sched))
        ph_depth.append(1 + max(step_of[s] for s in states))
    i16 = lambda a: np.array(a, dtype=np.int16)
    return i16(sched), i16(link), i16(edge), i16(ph_off), i16(ph_depth)


def hmm_sparse_numpy(hmm: Hmm) -> Dict[str, np.ndarray]:
    """Sparse tables for one HMM (see the module note), cached on the
    instance. `e_rank` (the rank R of each kept edge) is for the tests;
    the kernel needs only the order."""
    cached = getattr(hmm, "_torch_np_sparse", None)
    if cached is not None:
        return cached
    dense = hmm_dense_numpy(hmm)
    S = hmm.num_states
    e_off = np.zeros(S + 1, dtype=np.int32)
    srcs, lps, ranks = [], [], []
    for s in range(S):
        slot: Dict[int, int] = {}
        for e, (p, lp) in enumerate(zip(hmm.in_states[s], hmm.in_lps[s])):
            val = NEG if lp == float("-inf") else lp
            if p in slot:
                # duplicate src→dst edge: max value at the first rank
                lps[slot[p]] = max(lps[slot[p]], val)
            else:
                slot[p] = len(srcs)
                srcs.append(p)
                lps.append(val)
                ranks.append(e)
        e_off[s + 1] = len(srcs)
    levels = hmm.dense_tables()["silent_levels"]
    lv_off = np.zeros(len(levels) + 1, dtype=np.int16)
    for i, level in enumerate(levels):
        lv_off[i + 1] = lv_off[i] + len(level)
    e_src = np.array(srcs, dtype=np.int16)
    sched, sl_link, sl_edge, ph_off, ph_depth = _schedule(hmm, levels,
                                                          e_off, e_src)
    tables = dict(
        e_off=e_off,
        e_src=e_src,
        e_lp=np.array(lps, dtype=np.float64).astype(np.float32),
        e_rank=np.array(ranks, dtype=np.int16),
        lv_states=np.array([s for level in levels for s in level],
                           dtype=np.int16),
        lv_off=lv_off, sched=sched, sl_link=sl_link, sl_edge=sl_edge,
        ph_off=ph_off, ph_depth=ph_depth,
        em=dense["em"], silent=dense["silent"],
        has_edges=dense["has_edges"], num_levels=len(levels),
    )
    hmm._torch_np_sparse = tables
    return tables


def stack_sparse_tables(hmms: Sequence[Hmm]) -> Tuple[Dict[str, np.ndarray],
                                                      int]:
    """The sparse counterpart of `stack_tables`: one row per distinct HMM
    instance, padded to the batch maxima. Padding states are silent with
    no edges and sit in no phase; padded offsets repeat the
    last real one, so padded phases are empty. Returns (tables,
    num_levels)."""
    uniq: Dict[int, int] = {}
    per = []
    u_map = np.zeros(len(hmms), dtype=np.int32)
    for b, h in enumerate(hmms):
        u = uniq.get(id(h))
        if u is None:
            u = len(per)
            uniq[id(h)] = u
            per.append(hmm_sparse_numpy(h))
        u_map[b] = u
    U = len(per)
    S = max(p["em"].shape[0] for p in per)
    E = max(1, max(len(p["e_src"]) for p in per))
    NS = max(1, max(len(p["sched"]) for p in per))
    n_levels = max(p["num_levels"] for p in per)
    n_phases = max(len(p["ph_depth"]) for p in per)
    e_off = np.zeros((U, S + 1), dtype=np.int32)
    e_src = np.zeros((U, E), dtype=np.int16)
    e_lp = np.zeros((U, E), dtype=np.float32)
    sched = np.zeros((U, NS), dtype=np.int16)
    sl_link = np.zeros((U, NS), dtype=np.int16)
    sl_edge = np.full((U, NS), -1, dtype=np.int16)
    ph_off = np.zeros((U, n_phases + 1), dtype=np.int16)
    ph_depth = np.zeros((U, max(n_phases, 1)), dtype=np.int16)
    em = np.full((U, S, 5), NEG, dtype=np.float32)
    silent = np.ones((U, S), dtype=bool)
    has_edges = np.zeros((U, S), dtype=bool)
    no_edge_emit = np.zeros((U, S), dtype=bool)
    for u, p in enumerate(per):
        s = p["em"].shape[0]
        e_off[u, :s + 1] = p["e_off"]
        e_off[u, s + 1:] = p["e_off"][-1]
        e_src[u, :len(p["e_src"])] = p["e_src"]
        e_lp[u, :len(p["e_lp"])] = p["e_lp"]
        sched[u, :len(p["sched"])] = p["sched"]
        sl_link[u, :len(p["sl_link"])] = p["sl_link"]
        sl_edge[u, :len(p["sl_edge"])] = p["sl_edge"]
        ph_off[u, :len(p["ph_off"])] = p["ph_off"]
        ph_off[u, len(p["ph_off"]):] = p["ph_off"][-1]
        ph_depth[u, :len(p["ph_depth"])] = p["ph_depth"]
        em[u, :s] = p["em"]
        silent[u, :s] = p["silent"]
        has_edges[u, :s] = p["has_edges"]
        no_edge_emit[u, :s] = (~p["has_edges"]) & (~p["silent"])
    return dict(e_off=e_off, e_src=e_src, e_lp=e_lp, sched=sched,
                sl_link=sl_link, sl_edge=sl_edge, ph_off=ph_off,
                ph_depth=ph_depth, em=em, silent=silent, has_edges=has_edges,
                no_edge_emit=no_edge_emit, u_map=u_map), n_levels


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
