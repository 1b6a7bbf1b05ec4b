"""Genotype size record (ref: src/trgt/genotype/gt.rs)."""

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class TrSize:
    size: int
    ci: Tuple[int, int]


Gt = List[TrSize]  # at most 2 entries
