"""Seconds the parent's merge spent writing the workers' records, BGZF
deflate included (engine/runner.py `WorkerPool.merge`, `merge.write`),
in ms a locus the workers finished. The parent is this process."""

from .recorded import parent_recorder


def read(run):
    rec = parent_recorder()
    if rec is None or not run.loci or "merge.write" not in rec.STAGE_TIMES:
        return None
    return 1000.0 * rec.STAGE_TIMES["merge.write"] / run.loci
