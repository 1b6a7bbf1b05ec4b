from .fasta import FastaReader
from .catalog import Locus, parse_catalog_line, iter_loci, open_catalog
from .bgzf import BgzfReader, BgzfWriter
from .bam import BamReader, BamRecord, BamHeader
from .bam_write import BamWriter
from .vcf_write import VcfWriter

__all__ = [
    "FastaReader", "Locus", "parse_catalog_line", "iter_loci", "open_catalog",
    "BgzfReader", "BgzfWriter", "BamReader", "BamRecord", "BamHeader",
    "BamWriter", "VcfWriter",
]
