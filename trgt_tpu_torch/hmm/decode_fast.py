"""Vectorized (numpy) twins of the state-path decoders in decode.py.

The reference runs traceback post-processing per allele inside each rayon
worker (ref: src/trgt/workflows/tr.rs:454-492, src/hmm/purity.rs:6-41,
src/hmm/operations.rs:6-80, src/hmm/hmm_model.rs:158-200). Our batched
pipeline decodes entire locus batches at once, so the per-state Python
loops in decode.py become the dominant host cost on long alleles
(10-20kb expansions → 20-40k interpreter steps per allele). These twins
compute identical results with O(1) numpy passes over the path plus
O(#motif copies) assembly; equality with decode.py is enforced by
tests/test_decode_fast.py on randomized adversarial paths.

Only engine/pipeline.py uses these; engine/workflow.py keeps the
loop-for-loop reference replicas per the architecture invariant.
"""

from typing import List, Sequence

import numpy as np

from .decode import Span, get_base_match
from .model import Hmm

# kind codes for states strictly inside a motif block
_K_MATCH, _K_INS, _K_DEL = 0, 1, 2


def _tables(hmm: Hmm) -> dict:
    """Static per-state lookup tables, cached on the Hmm instance."""
    t = getattr(hmm, "_decode_fast", None)
    if t is not None:
        return t
    S = hmm.num_states
    emits = np.zeros(S, dtype=bool)
    block = np.full(S, -1, dtype=np.int32)     # index into hmm.motifs
    is_start = np.zeros(S, dtype=bool)
    is_end = np.zeros(S, dtype=bool)
    kind = np.full(S, -1, dtype=np.int8)
    expected = np.zeros(S, dtype=np.int32)     # get_base_match byte
    block_len = np.zeros(len(hmm.motifs), dtype=np.int32)
    for s in range(S):
        emits[s] = hmm.emits_base(s)
        if hmm.ems[s] is not None:
            expected[s] = get_base_match(hmm, s)
    for mi, m in enumerate(hmm.motifs):
        block[m.start_state:m.end_state + 1] = mi
        is_start[m.start_state] = True
        is_end[m.end_state] = True
        # ref operations.rs: motif_len = (end - start) / 3
        block_len[mi] = (m.end_state - m.start_state) // 3
        mlen = block_len[mi]
        if mlen > 0:
            inner = np.arange(m.start_state + 1, m.end_state)
            kind[inner] = np.minimum((inner - m.start_state - 1) // mlen,
                                     _K_DEL)
    t = dict(emits=emits, block=block, is_start=is_start, is_end=is_end,
             kind=kind, expected=expected, block_len=block_len,
             n_motifs=len(hmm.motifs))
    hmm._decode_fast = t
    return t


def fast_calc_purity(query: bytes, hmm: Hmm, motifs: Sequence[bytes],
                     states: Sequence[int]) -> float:
    """Vectorized calc_purity (ref: src/hmm/purity.rs:6-41 via
    events.rs:17-86); event taxonomy replicated exactly, including the
    start-state deletion arithmetic of events.rs:104-109."""
    if not query:
        return float("nan")
    t = _tables(hmm)
    st = np.asarray(states, dtype=np.int64)
    b = t["block"][st]
    starts = t["is_start"][st]
    inner = (b >= 0) & ~starts & ~t["is_end"][st]
    skip = inner & (b == t["n_motifs"] - 1)    # events.rs:113-116
    k = t["kind"][st]
    is_match = inner & ~skip & (k == _K_MATCH)
    n_ins = int(np.count_nonzero(inner & ~skip & (k == _K_INS)))
    n_del = int(np.count_nonzero(inner & ~skip & (k == _K_DEL)))
    n_skip = int(np.count_nonzero(skip))
    # DELs emitted at motif entry: next_state - state - 1 (events.rs:107)
    sidx = np.nonzero(starts)[0]
    sidx = sidx[sidx + 1 < len(st)]
    n_start_del = int(np.sum(st[sidx + 1] - st[sidx] - 1))
    # MATCH vs MISMATCH needs the consumed base per match state
    consumes = t["emits"][st]
    base_idx = np.cumsum(consumes) - consumes  # exclusive prefix sum
    q = np.frombuffer(query, dtype=np.uint8)
    exp = t["expected"][st]
    got = q[np.minimum(base_idx, len(q) - 1)]
    mism = is_match & (got != exp) & (exp != ord("N"))
    n_mism = int(np.count_nonzero(mism))
    n_match = int(np.count_nonzero(is_match)) - n_mism
    edit_dist = n_del + n_start_del + n_ins + n_mism + n_skip
    ref_len = n_match + n_mism + n_del + n_start_del + n_skip
    max_dist = max(ref_len, len(query))
    return (max_dist - edit_dist) / max_dist


def _span_segments(t: dict, st: np.ndarray):
    """Start indices + per-segment emitted-base counts for motif-copy
    spans: each span runs from a block-start state to just before the
    next one (silent non-block states between spans emit nothing)."""
    starts = np.nonzero(t["is_start"][st])[0]
    emit_counts = np.add.reduceat(t["emits"][st].astype(np.int64), starts) \
        if len(starts) else np.zeros(0, dtype=np.int64)
    return starts, emit_counts


def fast_label_motifs(hmm: Hmm, states: Sequence[int]) -> List[Span]:
    """Vectorized label_motifs (ref: src/hmm/hmm_model.rs:158-200)."""
    t = _tables(hmm)
    st = np.asarray(states, dtype=np.int64)
    if st.size == 0:
        return []
    starts, emit_counts = _span_segments(t, st)
    midx = t["block"][st[starts]]
    ends = np.cumsum(emit_counts)
    out = []
    prev = 0
    for mi, e in zip(midx.tolist(), ends.tolist()):
        out.append(Span(mi, prev, e))
        prev = e
    return out


def fast_remove_imperfect_motifs(hmm: Hmm, motifs: Sequence[bytes],
                                 states: Sequence[int], query: bytes,
                                 max_motif_len: int) -> List[int]:
    """Vectorized remove_imperfect_motifs (ref: src/hmm/operations.rs:6-80):
    motif copies whose emitted prefix mismatches the motif (short motifs
    only) are rewritten as skip-block states."""
    if not len(states):
        return []
    assert len(states) > 4
    t = _tables(hmm)
    st = np.asarray(states, dtype=np.int64)
    starts, emit_counts = _span_segments(t, st)
    # exclusive base offset of each span within query
    base_off = np.cumsum(emit_counts) - emit_counts
    midx = t["block"][st[starts]]
    mlens = t["block_len"][midx]
    skip_block = midx == (t["n_motifs"] - 1)
    # a motif copy = start..end-state inclusive; any trailing silent
    # non-block states before the next copy (run-end / run-start on
    # multi-run paths, and the final run-end/end pair) pass through
    # verbatim on both branches (operations.rs:60-66,74-78)
    ends_idx = np.nonzero(t["is_end"][st])[0]
    assert len(ends_idx) == len(starts)
    seg_next = np.empty(len(starts), dtype=np.int64)
    seg_next[:-1] = starts[1:]
    seg_next[-1] = len(st)
    skip = hmm.motifs[-1]
    pieces = [st[:starts[0]]] if len(starts) else [st]
    for i in range(len(starts)):
        keep = True
        if not skip_block[i] and mlens[i] <= max_motif_len:
            motif = motifs[midx[i]]
            c = int(emit_counts[i])
            if c < len(motif):
                keep = False
            else:
                off = int(base_off[i])
                got = query[off:off + len(motif)]
                if b"N" in motif:
                    keep = all(e == ord("N") or o == e
                               for e, o in zip(motif, got))
                else:
                    keep = got == motif
        if keep:
            pieces.append(st[starts[i]:ends_idx[i] + 1])
        else:
            c = int(emit_counts[i])
            repl = np.empty(c + 2, dtype=np.int64)
            repl[0] = skip.start_state
            repl[1:c + 1] = skip.start_state + 1
            repl[c + 1] = skip.end_state
            pieces.append(repl)
        pieces.append(st[ends_idx[i] + 1:seg_next[i]])
    return np.concatenate(pieces).tolist()
