"""Seconds from a worker's spawn to its readiness (engine/worker.py
`worker ready`), of the slowest worker."""


def read(run):
    ready = [w["ready_s"] for w in run.workers.values() if "ready_s" in w]
    return max(ready) if ready else None
