"""Plot input loaders (ref: src/trvz/input.rs, locus.rs)."""

from dataclasses import dataclass
from typing import List, Optional

from ..io.bam import BamReader
from ..io.catalog import (check_region_bounds, decode_fields,
                          get_tr_and_flanks, open_catalog)
from ..io.fasta import FastaReader
from ..merge.vcf_text import VcfTextReader
from ..utils import GenomicRegion
from .align import Beta, Betas


@dataclass
class PlotLocus:
    id: str
    struc: str
    motifs: List[str]
    left_flank: str
    right_flank: str
    region: GenomicRegion


@dataclass
class PlotRead:
    read_name: str
    seq: str
    left_flank: int
    right_flank: int
    allele: int
    betas: Betas


def get_locus(repeats_path: str, genome: FastaReader, tr_id: str,
              flank_len: int) -> PlotLocus:
    # ref: input.rs:55-73 — grep the catalog for "ID=<id>;"
    chrom_lookup = genome.chrom_lookup()
    query = f"ID={tr_id};"
    with open_catalog(repeats_path) as fh:
        for line_number, line in enumerate(fh, start=1):
            if query not in line:
                continue
            fields = line.split()
            if len(fields) != 4:
                raise ValueError(
                    f"Error at BED line {line_number}: expected 4 fields")
            chrom, start, end, info = fields
            region = GenomicRegion.from_string(f"{chrom}:{start}-{end}")
            check_region_bounds(region, flank_len, chrom_lookup)
            info_fields = decode_fields(info)
            left_flank, _, right_flank = get_tr_and_flanks(
                genome, region, flank_len)
            return PlotLocus(
                id=info_fields["ID"],
                struc=info_fields["STRUC"],
                motifs=info_fields["MOTIFS"].split(","),
                left_flank=left_flank,
                right_flank=right_flank,
                region=region,
            )
    raise ValueError(f"Unable to find locus {tr_id}")


def get_alleles(vcf_path: str, locus: PlotLocus) -> List[str]:
    # ref: input.rs:27-53, 201-227
    reader = VcfTextReader(vcf_path)
    for rec in reader.records(locus.region.contig, scan=True):
        trid = rec.info_field("TRID")
        if trid != locus.id:
            continue
        gt = rec.samples[0].get("GT", ".")
        if gt in (".", "./."):
            raise ValueError(f"Missing genotype for TRID={trid}")
        indexes = [int(x) for x in gt.replace("|", "/").split("/")]
        alleles = [rec.alleles[i] for i in indexes]
        if len(indexes) == 2 and indexes[0] != 0 \
                and len(alleles[0]) > len(alleles[1]):
            alleles[0], alleles[1] = alleles[1], alleles[0]
        # strip the padding base and re-attach flanks
        return [locus.left_flank + a[1:] + locus.right_flank
                for a in alleles]
    raise ValueError(f"TRID={locus.id} missing")


def parse_meth(mc_values: Optional[list], seq: str,
               read_name: str) -> Betas:
    # ref: input.rs:229-274
    if not mc_values:
        return []
    betas = []
    cpg_count = 0
    for pos in range(len(seq)):
        is_cpg = pos + 1 < len(seq) and seq[pos:pos + 2] == "CG"
        if is_cpg:
            if cpg_count == len(mc_values):
                raise ValueError(
                    f"Read '{read_name}' has a malformed MC tag")
            betas.append(Beta(pos=pos, value=mc_values[cpg_count] / 255.0))
            cpg_count += 1
    all_present = cpg_count == len(mc_values)
    last_split = seq.endswith("C") and cpg_count + 1 == len(mc_values)
    if not (all_present or last_split):
        raise ValueError(f"Read '{read_name}' has a malformed MC tag")
    return betas


def get_reads(bam_path: str, locus: PlotLocus,
              max_allele_reads: Optional[int]) -> List[PlotRead]:
    # ref: input.rs:75-199
    bam = BamReader(bam_path)
    search_radius = 1000
    start = max(0, locus.region.start - search_radius)
    end = locus.region.end + search_radius

    try:
        records = list(bam.fetch(locus.region.contig, start, end))
    except IOError:
        records = [r for r in bam
                   if not r.is_unmapped
                   and r.ref_id == bam.header.tid(locus.region.contig)]

    seqs: List[PlotRead] = []
    for rec in records:
        aux = rec.aux()
        trid = aux.get("TR")
        if trid is None:
            raise ValueError(
                f"Read '{rec.qname}' is missing the TR tag. Was this BAM "
                f"file generated by the latest version of TRGT?")
        if trid != locus.id:
            continue
        mc = aux.get("MC")
        mc_values = mc[1] if isinstance(mc, tuple) else None
        betas = parse_meth(mc_values, rec.seq, rec.qname)
        allele = aux.get("AL")
        if allele is None:
            raise ValueError(f"Read '{rec.qname}' is missing the AL tag")
        fl = aux.get("FL")
        if not isinstance(fl, tuple) or len(fl[1]) != 2:
            raise ValueError(f"Read '{rec.qname}' has malformed FL tag")
        seqs.append(PlotRead(
            read_name=rec.qname,
            seq=rec.seq,
            left_flank=fl[1][0],
            right_flank=fl[1][1],
            allele=int(allele),
            betas=betas,
        ))

    if max_allele_reads is not None:
        unique_alleles = list(dict.fromkeys(r.allele for r in seqs))
        out = []
        for allele in unique_alleles:
            allele_reads = [r for r in seqs if r.allele == allele]
            step = max(1, len(allele_reads) // max_allele_reads)
            out.extend(allele_reads[::step][:max_allele_reads])
        seqs = out

    if not seqs:
        raise ValueError(f"No reads found for TRID={locus.id}")
    return seqs
