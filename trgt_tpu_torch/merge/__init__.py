from .vcf_text import VcfTextReader, VcfRecord
from .exact import merge_exact

__all__ = ["VcfTextReader", "VcfRecord", "merge_exact"]
