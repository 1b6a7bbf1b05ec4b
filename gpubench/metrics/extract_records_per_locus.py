"""Mapped primary BAM records overlapping each locus's fetch window
that the native walk reached (reads/native_extract.py `extract_records`),
summed over the workers, a locus they finished: a read counts for every
locus it covers. The records the walk skipped before the window are not
counted."""

from .recorded import count_per_locus


def read(run):
    return count_per_locus(run, "extract_records")
