"""Genotyper / preset enums (ref: src/utils/genotyper.rs, presets.rs)."""

import enum


class Genotyper(enum.Enum):
    SIZE = "size"
    CLUSTER = "cluster"

    @classmethod
    def from_str(cls, s: str) -> "Genotyper":
        try:
            return cls(s)
        except ValueError:
            raise ValueError("Invalid genotyper") from None


class Preset(enum.Enum):
    WGS = "wgs"
    TARGETED = "targeted"

    @classmethod
    def from_str(cls, s: str) -> "Preset":
        try:
            return cls(s)
        except ValueError:
            raise ValueError(
                "Invalid preset. Options are: wgs, targeted") from None
