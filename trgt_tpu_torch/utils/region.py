"""Genomic region type (ref: src/utils/region.rs)."""

from dataclasses import dataclass


@dataclass(frozen=True)
class GenomicRegion:
    contig: str
    start: int  # 0-based
    end: int    # exclusive

    def __post_init__(self):
        if self.start >= self.end:
            raise ValueError(
                f"Invalid region: start {self.start} >= end {self.end}")

    @classmethod
    def from_string(cls, encoding: str) -> "GenomicRegion":
        # ref: src/utils/region.rs:23-35 — split on both ':' and '-'
        parts = encoding.replace(":", "\0").replace("-", "\0").split("\0")
        if len(parts) != 3:
            raise ValueError(f"Invalid region encoding: {encoding}")
        try:
            start, end = int(parts[1]), int(parts[2])
        except ValueError:
            raise ValueError(f"Invalid region encoding: {encoding}") from None
        if start < 0 or end < 0:
            raise ValueError(f"Invalid region encoding: {encoding}")
        return cls(parts[0], start, end)

    def intersect_position(self, position: int) -> bool:
        # ref: src/utils/region.rs:37-39 (inclusive on both ends)
        return self.start <= position <= self.end
