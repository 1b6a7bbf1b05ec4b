"""Seconds of the per-batch `torch.cuda.empty_cache()`
(engine/pipeline.py `release`), summed over the workers, in ms a locus
they finished."""

from .recorded import span_ms_per_locus


def read(run):
    return span_ms_per_locus(run, "release")
