"""Shared shape-bucketing policy.

Sizes snap to {2^k, 1.5·2^k} so padding waste is ≤ 33% (vs ≤ 100% for
pure powers of two) while the distinct-shape count stays ~2·log2(range)."""


def bucket(n: int, minimum: int = 8) -> int:
    size = minimum
    while size < n:
        if size * 3 // 2 >= n:
            return size * 3 // 2
        size *= 2
    return size


def chunk_ranges(n: int, chunk: int):
    """Yield (start, end) covering [0, n) in chunks of `chunk`."""
    start = 0
    while start < n:
        yield start, min(start + chunk, n)
        start += chunk
