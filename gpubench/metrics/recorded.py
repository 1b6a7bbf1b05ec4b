"""What the readers of the program's recorder (trgt_tpu_torch/utils/
recorder.py) share. A span or counter that no worker reported, as a
program without it reports none, reads None, not 0."""


def span_ms_per_locus(run, name: str):
    """Span `name`'s seconds summed over the workers that report it, in
    ms a locus the workers finished."""
    reported = [w["stages"][name] for w in run.workers.values()
                if name in w.get("stages", {})]
    if not run.loci or not reported:
        return None
    return 1000.0 * sum(reported) / run.loci


def count_per_locus(run, name: str):
    """Counter `name` summed over the workers that report it, a locus."""
    reported = [w["counts"][name] for w in run.workers.values()
                if name in w.get("counts", {})]
    if not run.loci or not reported:
        return None
    return sum(reported) / run.loci


def parent_recorder():
    """The program's recorder in this process, the pool's parent, where
    the program has one."""
    try:
        from trgt_tpu_torch.utils import recorder
    except ImportError:
        return None
    return recorder
