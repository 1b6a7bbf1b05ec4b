"""Host self time of the `spans` stage (engine/pipeline.py STAGE_TIMES),
summed over the workers, a locus they finished."""

from . import stage_ms_per_locus


def read(run):
    return stage_ms_per_locus(run, "spans")
