"""Seconds inside `extract` spent building the reads in Python
(reads/native_extract.py `extract.build`, `_deserialize`), summed over
the workers, in ms a locus they finished."""

from .recorded import span_ms_per_locus


def read(run):
    return span_ms_per_locus(run, "extract.build")
