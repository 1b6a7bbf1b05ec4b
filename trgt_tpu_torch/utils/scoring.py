"""Alignment scoring triple (ref: src/utils/align.rs TrgtScoring, cli.rs:583)."""

from dataclasses import dataclass


@dataclass(frozen=True)
class TrgtScoring:
    mism_scr: int
    gapo_scr: int
    gape_scr: int

    @classmethod
    def from_string(cls, s: str) -> "TrgtScoring":
        # ref: src/cli.rs:583-608 scoring_from_string — "MISM,GAPO,GAPE",
        # non-negative integers
        parts = s.split(",")
        if len(parts) != 3:
            raise ValueError(
                f"Expected 3 comma-separated values in scoring, found {len(parts)}")
        vals = []
        for p in parts:
            v = int(p)
            if v < 0:
                raise ValueError("Scoring values must be non-negative")
            vals.append(v)
        return cls(*vals)
