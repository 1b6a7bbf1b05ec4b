"""Motif-annotation HMM: topology construction + Viterbi labeling.

Replicates the reference HMM exactly (ref: the topology source under
src/hmm, src/hmm/hmm_model.rs) while exposing dense padded transition
tables so the same topology drives both the vectorized host Viterbi here
and the batched Pallas kernel in kernels/viterbi.py.

Topology per build_hmm (src/hmm topology source :4-78): start/end
terminals emitting '#', run-start/run-end silent states, one block of
3·len+1 states per motif (match/insert/delete + silent motif-end), and a
universal skip block.
"""

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

NEG_INF = float("-inf")


def encode_base(b: int) -> int:
    # ref: hmm_model.rs:243-252 — '#ATCG' → 0..4
    return {35: 0, 65: 1, 84: 2, 67: 3, 71: 4}[b]


@dataclass
class HmmMotif:
    start_state: int
    end_state: int
    motif_index: int


class Hmm:
    def __init__(self, num_states: int):
        self.num_states = num_states
        # emission log-probs; None ≙ reference's empty ems vec (silent)
        self.ems: List[Optional[List[float]]] = [None] * num_states
        self.in_states: List[List[int]] = [[] for _ in range(num_states)]
        self.in_lps: List[List[float]] = [[] for _ in range(num_states)]
        self.motifs: List[HmmMotif] = []
        self._dense = None

    # ---- construction (ref: hmm_model.rs:43-52) ----
    def set_trans(self, target: int, in_states: List[int],
                  in_probs: List[float]) -> None:
        self.in_states[target] = list(in_states)
        self.in_lps[target] = [math.log(p) if p > 0 else NEG_INF
                               for p in in_probs]

    def set_ems(self, target: int, ems: List[float]) -> None:
        assert len(ems) in (0, 5)
        if not ems:
            self.ems[target] = None
        else:
            self.ems[target] = [math.log(p) if p > 0 else NEG_INF
                                for p in ems]

    # ---- classification ----
    def is_silent(self, state: int) -> bool:
        ems = self.ems[state]
        return ems is None or all(e == NEG_INF for e in ems)

    def emits_base(self, state: int) -> bool:
        # ref: hmm_model.rs:202-204 — ignores the '#' column
        ems = self.ems[state]
        return ems is not None and any(e != NEG_INF for e in ems[1:])

    # ---- state ordering (ref: hmm_model.rs:206-240) ----
    def order_states(self) -> List[int]:
        normal = [s for s in range(self.num_states) if not self.is_silent(s)]
        silent = [s for s in range(self.num_states) if self.is_silent(s)]
        ordered = list(normal)
        levels = self.silent_levels()
        for level in levels:
            ordered.extend(level)
        assert len(ordered) == self.num_states
        return ordered

    def silent_levels(self) -> List[List[int]]:
        """Topological levels of silent states (each level depends only on
        earlier levels + emitting states)."""
        silent = [s for s in range(self.num_states) if self.is_silent(s)]
        silent_set = set(silent)
        placed = set()
        levels: List[List[int]] = []
        while silent:
            level = []
            rest = []
            for s in silent:
                deps = [p for p in self.in_states[s]
                        if p in silent_set and p not in placed]
                if not deps:
                    level.append(s)
                else:
                    rest.append(s)
            assert len(rest) < len(silent), "cycle among silent states"
            levels.append(level)
            placed.update(level)
            silent = rest
        return levels

    # ---- dense tables for vectorized/TPU Viterbi ----
    def dense_tables(self):
        if self._dense is not None:
            return self._dense
        S = self.num_states
        max_deg = max((len(x) for x in self.in_states), default=1)
        max_deg = max(max_deg, 1)
        in_idx = np.zeros((S, max_deg), dtype=np.int32)
        in_lp = np.full((S, max_deg), NEG_INF, dtype=np.float64)
        for s in range(S):
            for e, (p, lp) in enumerate(zip(self.in_states[s],
                                            self.in_lps[s])):
                in_idx[s, e] = p
                in_lp[s, e] = lp
        em = np.full((S, 5), NEG_INF, dtype=np.float64)
        for s in range(S):
            if self.ems[s] is not None:
                em[s] = self.ems[s]
        silent = np.array([self.is_silent(s) for s in range(S)], dtype=bool)
        levels = self.silent_levels()
        self._dense = dict(in_idx=in_idx, in_lp=in_lp, em=em, silent=silent,
                           silent_levels=levels,
                           emitting=np.where(~silent)[0],
                           has_edges=np.array(
                               [len(x) > 0 for x in self.in_states]))
        return self._dense

    def _native_tables(self):
        """Flat-array views of dense_tables for the native C twin
        (csrc/bamcodec.cpp trgt_hmm_label); cached per instance."""
        cached = getattr(self, "_native_dense", None)
        if cached is not None:
            return cached
        t = self.dense_tables()
        levels = t["silent_levels"]
        level_states = np.array([s for lv in levels for s in lv],
                                dtype=np.int32)
        level_off = np.zeros(len(levels) + 1, dtype=np.int32)
        for i, lv in enumerate(levels):
            level_off[i + 1] = level_off[i] + len(lv)
        tables = dict(
            S=self.num_states, E=t["in_idx"].shape[1],
            in_idx=np.ascontiguousarray(t["in_idx"], dtype=np.int32),
            in_lp=np.ascontiguousarray(t["in_lp"], dtype=np.float64),
            em=np.ascontiguousarray(t["em"], dtype=np.float64),
            silent=np.ascontiguousarray(t["silent"], dtype=np.uint8),
            has_edges=np.ascontiguousarray(t["has_edges"],
                                           dtype=np.uint8),
            n_levels=len(levels), level_off=level_off,
            level_states=level_states,
        )
        self._native_dense = tables
        return tables

    # ---- Viterbi (ref: hmm_model.rs:54-156) ----
    def label(self, query: str) -> List[int]:
        """Return the Viterbi state path for '#'+query+'#'."""
        if not query:
            return []
        sym = np.array([encode_base(b) for b in ("#" + query + "#").encode()],
                       dtype=np.int32)
        from ..io import native
        if native.get_lib() is not None:
            # native twin (double-precision adds + first-max ties match
            # the numpy path bit-for-bit; tests/test_native_align.py)
            cap = len(sym) * (len(self.dense_tables()["silent_levels"])
                              + 2) + 8
            path = native.hmm_label(self._native_tables(), sym, cap)
            if path is not None:
                return path
        t = self.dense_tables()
        S = self.num_states
        L = len(sym)
        in_idx, in_lp, em = t["in_idx"], t["in_lp"], t["em"]
        silent = t["silent"]
        has_edges = t["has_edges"]
        emitting = t["emitting"]
        levels = t["silent_levels"]

        scores = np.full((L, S), NEG_INF, dtype=np.float64)
        preds = np.zeros((L, S), dtype=np.int32)
        valid = np.zeros((L, S), dtype=bool)

        # index == 0 (ref: calc_viterbi_score special cases at
        # hmm_model.rs:70-72, 97-100): emitting states with in-edges are
        # skipped; the start state (no in-edges) seeds with its emission.
        col = np.full(S, NEG_INF)
        colp = np.zeros(S, dtype=np.int32)
        colv = np.zeros(S, dtype=bool)
        for s in range(S):
            if not silent[s] and len(self.in_states[s]) == 0:
                e0 = em[s, sym[0]]
                if e0 != NEG_INF:
                    col[s] = e0
                    colp[s] = s
                    colv[s] = True
        # silent states at index 0 pull from current column
        for level in levels:
            for s in level:
                best, bp = NEG_INF, -1
                for p, lp in zip(self.in_states[s], self.in_lps[s]):
                    v = col[p] + lp
                    if v > best:
                        best, bp = v, p
                if bp >= 0:
                    col[s] = best
                    colp[s] = bp
                    colv[s] = True
        scores[0], preds[0], valid[0] = col, colp, colv

        # positions 1..L-1, vectorized over states
        for i in range(1, L):
            prev = scores[i - 1]
            cand = prev[in_idx] + in_lp          # (S, E)
            best_e = np.argmax(cand, axis=1)     # first max wins
            best_v = cand[np.arange(S), best_e]
            best_p = in_idx[np.arange(S), best_e]
            em_term = em[:, sym[i]]
            col = np.where(silent, NEG_INF, best_v + em_term)
            colv = (~silent) & has_edges & (col > NEG_INF)
            # A state whose edges are all -inf keeps best_state None.
            colp = best_p.astype(np.int32)
            # silent states read the *current* column level by level
            for level in levels:
                for s in level:
                    best, bp = NEG_INF, -1
                    for p, lp in zip(self.in_states[s], self.in_lps[s]):
                        v = col[p] + lp
                        if v > best:
                            best, bp = v, p
                    if bp >= 0:
                        col[s] = best
                        colp[s] = bp
                        colv[s] = True
            scores[i], preds[i], valid[i] = col, colp, colv

        return self._traceback(sym, preds, valid)

    def _traceback(self, sym, preds, valid) -> List[int]:
        # ref: hmm_model.rs:125-142
        state = self.num_states - 1
        index = len(sym) - 1
        path = []
        while state != 0:
            path.append(state)
            if not valid[index, state]:
                raise ValueError("HMM traceback failed (no valid path)")
            prev_state = int(preds[index, state])
            if not self.is_silent(state):
                index -= 1
            state = prev_state
        path.append(0)
        path.reverse()
        return path


def get_match_emissions(base: int) -> List[float]:
    # ref: src/hmm topology source :175-184
    table = {
        ord("A"): [0.00, 0.90, 0.03, 0.03, 0.03],
        ord("T"): [0.00, 0.03, 0.90, 0.03, 0.03],
        ord("C"): [0.00, 0.03, 0.03, 0.90, 0.03],
        ord("G"): [0.00, 0.03, 0.03, 0.03, 0.90],
        ord("N"): [0.00, 0.25, 0.25, 0.25, 0.25],
    }
    if base not in table:
        raise ValueError(f"Encountered unknown base {chr(base)}")
    return table[base]


def _define_motif_block(hmm: Hmm, ms: int, motif: bytes) -> None:
    # ref: src/hmm topology source :80-173
    mlen = len(motif)
    match_states = list(range(ms + 1, ms + 1 + mlen))
    first_ins = match_states[-1] + 1
    ins_states = list(range(first_ins, first_ins + mlen))
    first_del = ins_states[-1] + 1
    del_states = list(range(first_del, first_del + mlen - 1))

    match_prob = 0.90
    ins_to_ins = 0.25
    match_to_indel = (1.00 - match_prob) / 2.00
    del_to_match = 0.50

    if mlen > 1:
        mismatch_seed_prob = 2.00 * (1.00 - match_prob) / (mlen * (mlen - 1))
    else:
        mismatch_seed_prob = 0.0  # unused when mlen == 1

    for match_index, match_state in enumerate(match_states):
        hmm.set_ems(match_state, get_match_emissions(motif[match_index]))
        if match_index == 0:
            hmm.set_trans(match_state, [ms], [match_prob])
        elif match_index == 1:
            multiplier = mlen - match_index
            mismatch_prob = mismatch_seed_prob * multiplier
            prev_ins = ins_states[match_index - 1]
            hmm.set_trans(match_state, [match_state - 1, ms, prev_ins],
                          [match_prob, mismatch_prob, 1.0 - ins_to_ins])
        else:
            multiplier = mlen - match_index
            mismatch_prob = mismatch_seed_prob * multiplier
            prev_ins = ins_states[match_index - 1]
            prev_del = del_states[match_index - 2]
            hmm.set_trans(
                match_state,
                [match_state - 1, ms, prev_ins, prev_del],
                [match_prob, mismatch_prob, 1.0 - ins_to_ins, del_to_match])

    for ins_index, ins_state in enumerate(ins_states):
        hmm.set_ems(ins_state, [0.00, 0.25, 0.25, 0.25, 0.25])
        hmm.set_trans(ins_state, [ins_state, match_states[ins_index]],
                      [ins_to_ins, match_to_indel])

    for del_index, del_state in enumerate(del_states):
        hmm.set_ems(del_state, [0.00, 0.00, 0.00, 0.00, 0.00])
        prev_match = match_states[del_index]
        if del_index == 0:
            hmm.set_trans(del_state, [prev_match], [match_to_indel])
        else:
            prev_del = del_states[del_index - 1]
            hmm.set_trans(del_state, [prev_match, prev_del],
                          [match_to_indel, 1.0 - del_to_match])

    me = ms + 3 * mlen
    hmm.set_ems(me, [0.00, 0.00, 0.00, 0.00, 0.00])
    if del_states:
        hmm.set_trans(me, [match_states[-1], ins_states[-1], del_states[-1]],
                      [match_prob, 1.0 - ins_to_ins, 1.0])
    elif ins_states:
        hmm.set_trans(me, [match_states[-1], ins_states[-1]],
                      [match_prob, 1.0 - ins_to_ins])
    else:
        hmm.set_trans(me, [match_states[-1]], [match_prob])


def build_hmm(motifs: Sequence[bytes]) -> Hmm:
    # ref: src/hmm topology source :4-78
    motifs = [bytes(m) for m in motifs]
    num_states = 7 + sum(3 * len(m) + 1 for m in motifs)
    hmm = Hmm(num_states)

    start = 0
    end = num_states - 1
    rs = start + 1
    re = end - 1

    hmm.set_ems(start, [1.00, 0.00, 0.00, 0.00, 0.00])
    hmm.set_ems(end, [1.00, 0.00, 0.00, 0.00, 0.00])
    hmm.set_trans(end, [re], [0.10])

    hmm.set_ems(rs, [0.00, 0.00, 0.00, 0.00, 0.00])
    hmm.set_trans(rs, [start, re], [1.00, 1.00])

    rs_to_ms = 1.00
    me_to_re = 0.50
    mes = []
    ms = rs + 1
    for motif in motifs:
        num_motif_states = 3 * len(motif) + 1
        me = ms + num_motif_states - 1
        hmm.set_ems(ms, [0.00, 0.00, 0.00, 0.00, 0.00])
        hmm.set_trans(ms, [rs, me], [rs_to_ms, 1.0 - me_to_re])
        _define_motif_block(hmm, ms, motif)
        mes.append(me)
        ms += num_motif_states

    assert ms + 3 == re

    # skip block (src/hmm topology source :41-57)
    skip_state, me = ms + 1, ms + 2
    hmm.set_ems(ms, [0.00, 0.00, 0.00, 0.00, 0.00])
    hmm.set_trans(ms, [rs, me], [rs_to_ms, 1.0 - me_to_re])

    skip_to_skip = 0.5
    hmm.set_ems(skip_state, [0.00, 0.25, 0.25, 0.25, 0.25])
    hmm.set_trans(skip_state, [ms, skip_state], [1.0, skip_to_skip])

    hmm.set_ems(me, [0.00, 0.00, 0.00, 0.00, 0.00])
    hmm.set_trans(me, [skip_state], [1.0 - skip_to_skip])
    mes.append(me)

    hmm.set_ems(re, [0.00, 0.00, 0.00, 0.00, 0.00])
    hmm.set_trans(re, list(mes), [me_to_re] * (len(motifs) + 1))

    for motif_index, motif in enumerate(motifs):
        me_i = mes[motif_index]
        ms_i = me_i - 3 * len(motif)
        hmm.motifs.append(HmmMotif(ms_i, me_i, motif_index))

    hmm.motifs.append(HmmMotif(skip_state - 1, skip_state + 1, len(motifs)))
    return hmm
