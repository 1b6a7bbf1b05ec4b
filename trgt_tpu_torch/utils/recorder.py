"""The program's span recorder: host seconds and counts by name, always
on, and a bounded timeline of the spans themselves while the `trgt`
logger is at DEBUG (`-vv`).

`timed(name)` times a block and adds its seconds to `STAGE_TIMES[name]`;
`count(name, n)` adds to `STAGE_COUNTS[name]`. A dotted name is a part of
the span named before the dot (`extract.decode` inside `extract`). The
sums are kept per process and summed over the threads that add to them,
so spans that run on other threads (the prefetch thread's `extract`, the
writer thread's `write`) overlap the others and the sums add up to more
than the wall time.

While the logger is at DEBUG each span is also an event of the timeline,
`(id, name, start, end, parent, thread)`: start and end in `time.time()`
seconds (the process's `perf_counter()` plus one offset taken as this
module is imported, the clock on which a device trace's events are
placed), the id of the innermost span open on the same thread when it
began (None at the top), and the thread's name. The timeline keeps the
first MAX_EVENTS top-level spans and, apart from them, the first
MAX_EVENTS spans inside another, and counts what each leaves out, so the
many parts of an extract never crowd out a thread's top-level spans.

A `-t N` worker sends its timeline to the parent at the end of its
stream (`table`, engine/worker.py), and the parent keeps each worker's
in `WORKER_TABLES` (engine/runner.py `WorkerPool`).
"""

import contextlib
import itertools
import logging
import threading
import time
from collections import Counter

# seconds and counts by name, summed over the threads of this process.
# The counts: reads the impure-read filter labelled with the Viterbi path
# and dropped ("impure_filter_labelled", "impure_filter_dropped"), and the
# mapped primary BAM records overlapping each locus's fetch window that
# the native extraction walked to ("extract_records")
STAGE_TIMES: Counter = Counter()
STAGE_COUNTS: Counter = Counter()
# perf_counter() + OFFSET is time.time(), the wall clock
OFFSET = time.time() - time.perf_counter()
# events a process keeps of each kind, top-level and nested (some 20 MB
# each). On 30x WGS reads a worker records 1.1-1.3 top-level spans a locus
# (its main thread's, a batch's extract) and 22-28 nested (an extract's
# parts, two for each BAI chunk): 10^5 hold some 80,000 and 3,500 loci
MAX_EVENTS = 100_000
# {worker index: {"dropped": n, "dropped_nested": n, "rows": [[card, id,
# name, start, end, parent, thread], ...]}} of the last worker pool, in
# the parent
WORKER_TABLES: dict = {}

_LOCK = threading.Lock()
_LOG = logging.getLogger("trgt")
_TIMELINE: list = []
_KEPT = [0, 0]                 # events kept: top-level, nested
_DROPPED = [0, 0]              # events left out: top-level, nested
_IDS = itertools.count()
_OPEN = threading.local()      # ids of the spans open on each thread


def tracing() -> bool:
    """Whether spans go on the timeline: the `trgt` logger at DEBUG."""
    return _LOG.isEnabledFor(logging.DEBUG)


@contextlib.contextmanager
def timed(name: str):
    """Time the block as span `name` (module docstring)."""
    if not tracing():
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _LOCK:
                STAGE_TIMES[name] += dt
        return
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    sid = next(_IDS)
    parent = stack[-1] if stack else None
    stack.append(sid)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        stack.pop()
        event = (sid, name, t0 + OFFSET, t1 + OFFSET, parent,
                 threading.current_thread().name)
        nested = parent is not None
        with _LOCK:
            STAGE_TIMES[name] += t1 - t0
            if _KEPT[nested] < MAX_EVENTS:
                _KEPT[nested] += 1
                _TIMELINE.append(event)
            else:
                _DROPPED[nested] += 1


def add_time(name: str, seconds: float) -> None:
    """Add seconds timed otherwise (a thread's CPU time) to `name`."""
    with _LOCK:
        STAGE_TIMES[name] += seconds


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        STAGE_COUNTS[name] += n


def timeline() -> list:
    """The events kept so far, in the order their spans ended."""
    with _LOCK:
        return list(_TIMELINE)


def dropped() -> tuple:
    """(top-level, nested) events left out since their store filled."""
    with _LOCK:
        return tuple(_DROPPED)


def table(card: int) -> dict:
    """This process's timeline as a worker sends it: every row led by
    the index of the worker's card (-1 off a card)."""
    top, nested = dropped()
    return {"dropped": top, "dropped_nested": nested,
            "rows": [[card, *event] for event in timeline()]}


def clear() -> None:
    """Forget every sum, count, event and worker table."""
    with _LOCK:
        STAGE_TIMES.clear()
        STAGE_COUNTS.clear()
        _TIMELINE.clear()
        _KEPT[:] = [0, 0]
        _DROPPED[:] = [0, 0]
        WORKER_TABLES.clear()
