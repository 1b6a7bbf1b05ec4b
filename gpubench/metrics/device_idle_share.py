"""Share of the window in which no operation ran on the card, from the
profiler's trace of every worker (the union of their device events),
averaged over the cards used."""


def read(run):
    if not run.trace:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / (run.trace.t1 - run.trace.t0))
