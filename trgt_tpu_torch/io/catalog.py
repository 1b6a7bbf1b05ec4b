"""Repeat catalog (BED) parsing → Locus (ref: src/trgt/locus.rs).

The catalog shard planner for the TPU engine starts from these host-side
Locus records: parse BED, fetch flanks, then bucket by shape for batched
device dispatch (engine/batch.py).
"""

import gzip
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from ..utils import GenomicRegion, Karyotype, Ploidy, Genotyper
from .fasta import FastaReader


@dataclass
class Locus:
    id: str
    left_flank: str
    tr: str
    right_flank: str
    region: GenomicRegion
    motifs: List[str]
    struc: str
    ploidy: Ploidy
    genotyper: Genotyper


def decode_fields(info_fields: str) -> Dict[str, str]:
    # ref: src/trgt/locus.rs:199-218
    fields: Dict[str, str] = {}
    for encoding in info_fields.split(";"):
        parts = encoding.split("=", 1)
        if len(parts) != 2 or not parts[0] or not parts[1]:
            raise ValueError(
                f"Field must be in 'name=value' format: '{encoding}'")
        if parts[0] in fields:
            raise ValueError(f"Duplicate field name: '{parts[0]}'")
        fields[parts[0]] = parts[1]
    return fields


def check_region_bounds(region: GenomicRegion, flank_len: int,
                        chrom_lookup: Dict[str, int]) -> None:
    # ref: src/trgt/locus.rs:220-256
    if region.contig not in chrom_lookup:
        raise ValueError(
            f"FASTA reference does not contain chromosome "
            f"'{region.contig}' in BED file")
    chrom_length = chrom_lookup[region.contig]
    if region.start < flank_len + 1:
        raise ValueError(
            f"Region start '{region.start}' with flank length '{flank_len}' "
            f"underflows for chromosome '{region.contig}'.")
    if region.end + flank_len > chrom_length:
        raise ValueError(
            f"Region end '{region.end + flank_len}' with flank length "
            f"'{flank_len}' exceeds chromosome '{region.contig}' bounds "
            f"(0..{chrom_length}).")


def get_tr_and_flanks(genome: FastaReader, region: GenomicRegion,
                      flank_len: int) -> Tuple[str, str, str]:
    # ref: src/trgt/locus.rs:168-190 — htslib fetch is 0-based inclusive of
    # both ends, so [start-flank, start-1] == python [start-flank:start].
    left = genome.fetch(region.contig, region.start - flank_len,
                        region.start).upper()
    tr = genome.fetch(region.contig, region.start, region.end).upper()
    right = genome.fetch(region.contig, region.end,
                         region.end + flank_len).upper()
    return left, tr, right


def parse_catalog_line(genome: FastaReader, chrom_lookup: Dict[str, int],
                       line: str, flank_len: int, karyotype: Karyotype,
                       genotyper: Genotyper) -> Locus:
    # ref: src/trgt/locus.rs:26-75
    fields = line.split()
    if len(fields) != 4:
        raise ValueError(
            f"Expected 4 fields in the format 'chrom start end info', "
            f"found {len(fields)}: {line}")
    chrom, start, end, info = fields
    region = GenomicRegion.from_string(f"{chrom}:{start}-{end}")
    check_region_bounds(region, flank_len, chrom_lookup)
    ploidy = karyotype.get_ploidy(chrom)
    info_fields = decode_fields(info)
    for key in ("ID", "MOTIFS", "STRUC"):
        if key not in info_fields:
            raise ValueError(f"{key} field missing")
    left_flank, tr, right_flank = get_tr_and_flanks(genome, region, flank_len)
    return Locus(
        id=info_fields["ID"],
        left_flank=left_flank,
        tr=tr,
        right_flank=right_flank,
        region=region,
        motifs=info_fields["MOTIFS"].split(","),
        struc=info_fields["STRUC"],
        ploidy=ploidy,
        genotyper=genotyper,
    )


def open_catalog(path: str):
    # ref: src/utils/io_utils.rs:8-26 — transparently handle .gz/.gzip
    lower = path.lower()
    if lower.endswith(".gz") or lower.endswith(".gzip"):
        return gzip.open(path, "rt")
    return open(path)


def iter_loci(repeats_path: str, genome: FastaReader, karyotype: Karyotype,
              flank_len: int, genotyper: Genotyper,
              on_error=None) -> Iterator[Locus]:
    """Stream loci from a catalog; errors are reported via on_error and the
    line skipped (ref: src/trgt/locus.rs:95-137)."""
    chrom_lookup = genome.chrom_lookup()
    with open_catalog(repeats_path) as fh:
        for line_number, line in enumerate(fh, start=1):
            line = line.rstrip("\n")
            if not line.strip():
                continue
            try:
                yield parse_catalog_line(genome, chrom_lookup, line,
                                         flank_len, karyotype, genotyper)
            except ValueError as e:
                msg = f"Error at BED line {line_number}: {e}"
                if on_error is not None:
                    on_error(msg)
                else:
                    raise ValueError(msg) from None
