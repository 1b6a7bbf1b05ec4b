"""Seconds the worker spent rendering each locus's VCF line and BAM
records and writing its frame to the parent (engine/worker.py `render`),
summed over the workers, in ms a locus they finished."""

from .recorded import span_ms_per_locus


def read(run):
    return span_ms_per_locus(run, "render")
