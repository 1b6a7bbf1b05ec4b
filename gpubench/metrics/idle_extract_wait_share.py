"""Share of the window in which the card idled while a worker's main
thread waited for its prefetched batch (`extract_wait`), from the device
trace and the span tables the workers sent the parent, this process
(trgt_tpu_torch/utils/recorder.py `WORKER_TABLES`).

`idle_split` gives the share of every state of the workers' main
threads: a card's idle intervals in the window (the complement of the
union of its device events, as `DeviceTrace.busy_s` builds it) are
intersected with each of its workers' top-level main-thread spans, which
never overlap: `grant_wait`, `extract_wait`, the stages, `release`,
`render`, and "no span" for the idle time that none of them covers. A
state's share is 100 x its overlap summed over the card's workers, over
(workers x window), averaged over the cards as `device_idle_share` is,
so the shares add up to `device_idle_share`.

A worker whose timeline left out top-level spans (its table's `dropped`)
has no state for the end of the window, so its idle time there would
read as "no span": the split is then None, not a smaller share.
"""

import numpy as np

from ..trace import _union
from .recorded import parent_recorder

NO_SPAN = "no span"
MAIN_THREAD = "MainThread"


def _idle_intervals(trace):
    """{card: (starts, ends)} of the card's idle intervals in the window,
    for every card a traced worker used."""
    by_card = {}
    for w, s, e, _ in trace._window_events():
        starts, ends = by_card.setdefault(int(w["card"]), ([], []))
        starts.append(s)
        ends.append(e)
    out = {}
    for card, (starts, ends) in by_card.items():
        idle, reach = [], trace.t0
        for s, e in _union(np.concatenate(starts), np.concatenate(ends)):
            if s > reach:
                idle.append((reach, s))
            reach = max(reach, e)
        if trace.t1 > reach:
            idle.append((reach, trace.t1))
        arr = np.array(idle, dtype=float).reshape(-1, 2)
        out[card] = (arr[:, 0], arr[:, 1])
    return out


def _covered(idle, a, b) -> float:
    """Idle seconds inside the intervals [a, b], summed."""
    starts, ends = idle
    if not len(starts) or not len(a):
        return 0.0
    lens = ends - starts
    before = np.concatenate(([0.0], np.cumsum(lens)))

    def upto(x):
        k = np.searchsorted(starts, x, side="right") - 1
        kk = np.maximum(k, 0)
        inside = np.clip(x - starts[kk], 0.0, lens[kk])
        return np.where(k >= 0, before[kk] + inside, 0.0)

    return float(np.sum(upto(np.asarray(b)) - upto(np.asarray(a))))


def idle_split(trace, tables):
    """{state: % of the window} of the card's idle time by what the main
    thread of each worker on it was doing (module docstring); None
    without a trace or a table, or where a table dropped a top-level
    span."""
    if not trace or not tables:
        return None
    if any(table.get("dropped", 0) for table in tables.values()):
        return None
    window = trace.t1 - trace.t0
    idle = _idle_intervals(trace)
    spans_by_card = {}
    for table in tables.values():
        rows = [r for r in table["rows"]
                if r[6] == MAIN_THREAD and r[5] is None]
        if table["rows"]:
            spans_by_card.setdefault(int(table["rows"][0][0]),
                                     []).append(rows)
    split = {NO_SPAN: 0.0}
    for card, card_idle in idle.items():
        idle_s = float(np.sum(card_idle[1] - card_idle[0]))
        workers = spans_by_card.get(card, [])
        if not workers:
            split[NO_SPAN] += 100.0 * idle_s / window / len(idle)
            continue
        scale = 100.0 / (len(workers) * window * len(idle))
        for rows in workers:
            by_name = {}
            for r in rows:
                by_name.setdefault(r[2], ([], []))
                by_name[r[2]][0].append(r[3])
                by_name[r[2]][1].append(r[4])
            for name, (a, b) in by_name.items():
                split[name] = split.get(name, 0.0) + scale * _covered(
                    card_idle, a, b)
            merged = (_union(np.array([r[3] for r in rows]),
                             np.array([r[4] for r in rows]))
                      if rows else [])
            in_spans = _covered(card_idle, [s for s, _ in merged],
                                [e for _, e in merged])
            split[NO_SPAN] += scale * (idle_s - in_spans)
    return split


def read(run):
    rec = parent_recorder()
    if rec is None:
        return None
    split = idle_split(run.trace, rec.WORKER_TABLES)
    return None if split is None else split.get("extract_wait", 0.0)
