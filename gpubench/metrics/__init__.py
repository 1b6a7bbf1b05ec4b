"""Readers of the per-layer metrics, one module a metric, named as the
metric is in BENCHMARK.json. Each has `read(run)`, which returns the
metric's value, or None where the run has nothing to read for it (the
harness then leaves the metric out of the line). `run` is the harness's
`Run`: `workers` (trace.worker_lines), `trace` (a trace.DeviceTrace, or
None), `loci` (loci the workers finished)."""


def stage_ms_per_locus(run, stage: str):
    """A stage's host seconds summed over the workers, in ms a locus."""
    if not run.loci:
        return None
    total = sum(w.get("stages", {}).get(stage, 0.0)
                for w in run.workers.values())
    return 1000.0 * total / run.loci
