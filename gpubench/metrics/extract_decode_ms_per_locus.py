"""Seconds inside `extract` spent in the native record walk
(reads/native_extract.py `extract.decode`, `trgt_extract_reads`),
summed over the workers, in ms a locus they finished."""

from .recorded import span_ms_per_locus


def read(run):
    return span_ms_per_locus(run, "extract.decode")
