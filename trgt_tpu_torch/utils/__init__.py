from .region import GenomicRegion
from .karyotype import Karyotype, Ploidy
from .enums import Genotyper, Preset
from .scoring import TrgtScoring

__all__ = [
    "GenomicRegion",
    "Karyotype",
    "Ploidy",
    "Genotyper",
    "Preset",
    "TrgtScoring",
]
