"""BGZF bytes the extract walks inflated, the blocks their readers'
caches missed (reads/native_extract.py `extract_inflated_bytes`), summed
over the workers, in MiB a locus they finished."""

from .recorded import count_per_locus


def read(run):
    value = count_per_locus(run, "extract_inflated_bytes")
    return None if value is None else value / 2**20
