"""The largest worker's caching-allocator peak
(torch.cuda.max_memory_reserved, read as the traced worker ends), MiB."""


def read(run):
    return run.trace.max_reserved() / 2**20 if run.trace else None
