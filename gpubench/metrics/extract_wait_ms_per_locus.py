"""Seconds the worker's main thread waited for the prefetched batch
(engine/pipeline.py `extract_wait`), summed over the workers, in ms a
locus they finished: the part of `extract` the other stages did not
hide."""

from .recorded import span_ms_per_locus


def read(run):
    return span_ms_per_locus(run, "extract_wait")
