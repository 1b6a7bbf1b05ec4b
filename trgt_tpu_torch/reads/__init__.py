from .hifi_read import HiFiRead, Cigar
from .clip import clip_to_region, clip_bases

__all__ = ["HiFiRead", "Cigar", "clip_to_region", "clip_bases"]
