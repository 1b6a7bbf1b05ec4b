"""Karyotype / ploidy handling (ref: src/utils/karyotype.rs, ploidy.rs)."""

import enum
import os
from typing import Dict, Optional


class Ploidy(enum.IntEnum):
    ZERO = 0
    ONE = 1
    TWO = 2

    @classmethod
    def from_str(cls, s: str) -> "Ploidy":
        if s not in ("0", "1", "2"):
            raise ValueError("must be set to 0, 1, or 2")
        return cls(int(s))


class Karyotype:
    """Maps chromosomes to ploidies.

    Presets "XX"/"XY" follow ref src/utils/karyotype.rs:76-92; anything
    else is interpreted as a path to a two-column "chrom ploidy" file
    (karyotype.rs:38-70).
    """

    def __init__(self, preset: Optional[str] = None,
                 ploidies: Optional[Dict[str, Ploidy]] = None):
        self._preset = preset
        self._ploidies = ploidies

    @classmethod
    def new(cls, encoding: str) -> "Karyotype":
        if encoding in ("XX", "XY"):
            return cls(preset=encoding)
        if not os.path.exists(encoding):
            raise ValueError(f"File {encoding}: not found")
        with open(encoding) as fh:
            return cls.from_lines(fh, encoding)

    @classmethod
    def from_lines(cls, lines, source: str = "<memory>") -> "Karyotype":
        ploidies: Dict[str, Ploidy] = {}
        for line_number, line in enumerate(lines, start=1):
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(
                    f"Missing chromosome/ploidy at line {line_number}")
            chrom, ploidy_str = parts[0], parts[1]
            try:
                ploidy = Ploidy.from_str(ploidy_str)
            except ValueError as e:
                raise ValueError(
                    f"Invalid ploidy at line {line_number}, {e}") from None
            if chrom in ploidies:
                raise ValueError(
                    f"Duplicate chromosome entry at line {line_number}: {chrom}")
            ploidies[chrom] = ploidy
        return cls(ploidies=ploidies)

    def get_ploidy(self, chrom: str) -> Ploidy:
        if self._preset == "XX":
            return Ploidy.ZERO if chrom in ("Y", "chrY") else Ploidy.TWO
        if self._preset == "XY":
            if chrom in ("X", "chrX", "Y", "chrY"):
                return Ploidy.ONE
            return Ploidy.TWO
        assert self._ploidies is not None
        if chrom in self._ploidies:
            return self._ploidies[chrom]
        raise ValueError(f"Ploidy was not specified for chromosome: {chrom}")
