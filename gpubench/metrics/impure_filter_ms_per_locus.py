"""Host self time of the impure-read filter (engine/pipeline.py
STAGE_TIMES["impure_filter"]) a locus, where it labelled reads."""

from . import stage_ms_per_locus


def read(run):
    labelled = sum(w.get("counts", {}).get("impure_filter_labelled", 0)
                   for w in run.workers.values())
    return stage_ms_per_locus(run, "impure_filter") if labelled else None
