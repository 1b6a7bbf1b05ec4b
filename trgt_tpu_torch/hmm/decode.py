"""HMM state-path decoding: motif spans, alignment events, purity
(ref: src/hmm/hmm_model.rs:158-200, events.rs, purity.rs, operations.rs,
utils.rs, spans.rs)."""

import enum
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

from .model import Hmm

NEG_INF = float("-inf")


@dataclass
class Span:
    motif_index: int
    start: int
    end: int

    def __len__(self):
        return self.end - self.start


@dataclass
class Annotation:
    labels: Optional[List[Span]]
    motif_counts: List[int]
    purity: float


class HmmEvent(enum.Enum):
    MATCH = "match"
    MISMATCH = "mismatch"
    INS = "ins"
    DEL = "del"
    TRANS = "trans"
    SKIP = "skip"
    MOTIF_START = "motif_start"
    MOTIF_END = "motif_end"


def label_motifs(hmm: Hmm, states: Sequence[int]) -> List[Span]:
    # ref: hmm_model.rs:158-200
    state_to_motif = {m.start_state: i for i, m in enumerate(hmm.motifs)}
    motif_spans: List[Span] = []
    state_index = 0
    n = len(states)
    while state_index < n:
        state = states[state_index]
        if state in state_to_motif:
            motif_index = state_to_motif[state]
            motif = hmm.motifs[motif_index]
            motif_span = 0
            while states[state_index] != motif.end_state:
                motif_span += int(hmm.emits_base(states[state_index]))
                state_index += 1
            while state_index < n and states[state_index] == motif.end_state:
                motif_span += int(hmm.emits_base(states[state_index]))
                state_index += 1
            motif_start = motif_spans[-1].end if motif_spans else 0
            motif_spans.append(Span(motif_index, motif_start,
                                    motif_start + motif_span))
        else:
            assert not hmm.emits_base(state)
            state_index += 1
    return motif_spans


def get_base_match(hmm: Hmm, state: int) -> int:
    # ref: events.rs:89-117
    ems = hmm.ems[state]
    assert ems is not None and len(ems) == 5
    if not hmm.emits_base(state):
        return ord(" ")
    max_lp = max(ems)
    top = [i for i, p in enumerate(ems) if p == max_lp]
    if len(top) == 1:
        return b"#ATCG"[top[0]]
    if len(top) == 4:
        return ord("N")
    return ord(" ")


def get_events(hmm: Hmm, motifs: Sequence[bytes], states: Sequence[int],
               query: bytes) -> List[HmmEvent]:
    # ref: events.rs:17-86
    state_to_hmm_motif = [-1] * hmm.num_states
    for motif_index, m in enumerate(hmm.motifs):
        for s in range(m.start_state, m.end_state + 1):
            state_to_hmm_motif[s] = motif_index

    base_index = 0
    events: List[HmmEvent] = []
    base_consumers = (HmmEvent.MATCH, HmmEvent.MISMATCH, HmmEvent.INS,
                      HmmEvent.SKIP)
    for state_index in range(len(states)):
        state = states[state_index]
        motif_index = state_to_hmm_motif[state]
        if motif_index == -1:
            events.append(HmmEvent.TRANS)
            continue
        hmm_motif = hmm.motifs[motif_index]
        if state == hmm_motif.start_state:
            events.append(HmmEvent.MOTIF_START)
            next_state = states[state_index + 1]
            num_dels = next_state - state - 1
            events.extend([HmmEvent.DEL] * num_dels)
            continue
        if state == hmm_motif.end_state:
            events.append(HmmEvent.MOTIF_END)
            continue
        if motif_index + 1 == len(hmm.motifs):
            events.append(HmmEvent.SKIP)
            base_index += 1
            continue
        offset = state - hmm_motif.start_state - 1
        motif_len = len(motifs[hmm_motif.motif_index])
        kind = offset // motif_len
        if kind == 0:
            base = query[base_index]
            expected = get_base_match(hmm, state)
            event = (HmmEvent.MATCH
                     if base == expected or expected == ord("N")
                     else HmmEvent.MISMATCH)
        elif kind == 1:
            event = HmmEvent.INS
        elif kind == 2:
            event = HmmEvent.DEL
        else:
            raise ValueError("Event decoding error")
        if event in base_consumers:
            base_index += 1
        events.append(event)
    return events


def calc_purity(query: bytes, hmm: Hmm, motifs: Sequence[bytes],
                states: Sequence[int]) -> float:
    # ref: purity.rs:6-41
    if not query:
        return float("nan")
    events = get_events(hmm, motifs, states, query)
    edit_dist = sum(1 for e in events if e in (
        HmmEvent.DEL, HmmEvent.INS, HmmEvent.MISMATCH, HmmEvent.SKIP))
    ref_len = sum(1 for e in events if e in (
        HmmEvent.MATCH, HmmEvent.MISMATCH, HmmEvent.DEL, HmmEvent.SKIP))
    max_dist = max(ref_len, len(query))
    return (max_dist - edit_dist) / max_dist


def remove_imperfect_motifs(hmm: Hmm, motifs: Sequence[bytes],
                            states: Sequence[int], query: bytes,
                            max_motif_len: int) -> List[int]:
    # ref: operations.rs:6-80 — replace imperfect short-motif copies with
    # skip states
    if not states:
        return []
    start_state_to_motif = {m.start_state: m for m in hmm.motifs}
    assert len(states) > 4
    updated = [states[0], states[1]]

    motif_start_states = {m.start_state for m in hmm.motifs}
    motif_end_states = {m.end_state for m in hmm.motifs}
    motif_run_end_state = hmm.num_states - 2

    state_index = 2
    base_index = 0
    n = len(states)
    while state_index != n:
        assert states[state_index] in motif_start_states
        motif_states = []
        motif_sequence = bytearray()
        while states[state_index] not in motif_end_states:
            motif_states.append(states[state_index])
            if hmm.emits_base(states[state_index]):
                motif_sequence.append(query[base_index])
                base_index += 1
            state_index += 1
        motif_states.append(states[state_index])
        state_index += 1

        motif_rec = start_state_to_motif[motif_states[0]]
        motif_len = (motif_rec.end_state - motif_rec.start_state) // 3
        keep = True
        skip_motif = motif_rec.motif_index + 1 == len(hmm.motifs)
        if not skip_motif and motif_len <= max_motif_len:
            motif = motifs[motif_rec.motif_index]
            if len(motif_sequence) < len(motif):
                keep = False
            else:
                for expected, observed in zip(motif,
                                              motif_sequence[:len(motif)]):
                    if expected != ord("N") and observed != expected:
                        keep = False
        if keep:
            updated.extend(motif_states)
        else:
            bases_consumed = sum(1 for s in motif_states
                                 if hmm.emits_base(s))
            skip = hmm.motifs[-1]
            updated.append(skip.start_state)
            updated.extend([skip.start_state + 1] * bases_consumed)
            updated.append(skip.end_state)

        if states[state_index] == motif_run_end_state:
            updated.extend(states[state_index:state_index + 2])
            state_index += 2
    return updated


def count_motifs(motifs: Sequence[str], labels: List[Span]) -> List[int]:
    # ref: hmm/utils.rs:3-9
    counts = [0] * len(motifs)
    for span in labels:
        counts[span.motif_index] += 1
    return counts


def collapse_labels(spans: List[Span]) -> List[Span]:
    # ref: hmm/utils.rs:11-27
    collapsed: List[Span] = []
    for span in spans:
        if collapsed and collapsed[-1].motif_index == span.motif_index \
                and collapsed[-1].end == span.start:
            collapsed[-1].end = span.end
        else:
            collapsed.append(Span(span.motif_index, span.start, span.end))
    return collapsed


def replace_invalid_bases(seq: str, allowed: str) -> str:
    # ref: hmm/utils.rs:29-42
    return "".join(
        c if c in allowed else allowed[i % len(allowed)]
        for i, c in enumerate(seq))
