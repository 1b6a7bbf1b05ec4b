"""Seconds inside `extract` spent reading and inflating BGZF chunks,
their cache included (reads/native_extract.py `extract.inflate`),
summed over the workers, in ms a locus they finished."""

from .recorded import span_ms_per_locus


def read(run):
    return span_ms_per_locus(run, "extract.inflate")
