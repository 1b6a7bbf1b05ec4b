"""Share of the BGZF blocks the extract walks touched that their readers'
caches served (reads/native_extract.py `extract_blocks_cached` over it
and `extract_blocks_inflated`), over the workers, in %."""


def read(run):
    cached = inflated = 0
    reported = False
    for w in run.workers.values():
        counts = w.get("counts", {})
        if "extract_blocks_cached" in counts or \
                "extract_blocks_inflated" in counts:
            reported = True
            cached += counts.get("extract_blocks_cached", 0)
            inflated += counts.get("extract_blocks_inflated", 0)
    if not reported or cached + inflated == 0:
        return None
    return 100.0 * cached / (cached + inflated)
