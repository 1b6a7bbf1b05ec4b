"""The least time the card could take for the kernels' counted work
(peaks.bound_s over every class of kernels/telemetry.py's counters),
summed over the workers, in ms a locus they finished."""

from .. import peaks


def read(run):
    if not run.loci:
        return None
    total = sum(peaks.bound_s(k, c) for w in run.workers.values()
                for k, c in w.get("kernels", {}).items()
                if k in peaks.OPS_PER_CELL)
    return 1000.0 * total / run.loci if total else None
