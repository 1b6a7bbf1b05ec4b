"""Exact merge strategy (ref: src/merge/strategy/exact.rs).

Genotype alleles are (index, phased) pairs; index None means missing."""

from typing import List, Optional, Sequence, Tuple

GtAllele = Tuple[Optional[int], bool]  # (allele index or None, phased)


def merge_exact(vcf_gts: Sequence[Sequence[Sequence[GtAllele]]],
                sample_alleles: Sequence[Sequence[str]]):
    """vcf_gts: per VCF → per sample → list of GT alleles.
    sample_alleles: per VCF → its record's alleles ([] for missing).
    Returns (remapped gts in the same nesting, merged allele list)."""
    ref_allele = None
    all_alleles = set()
    for alleles in sample_alleles:
        if alleles:
            if ref_allele is not None:
                if ref_allele != alleles[0]:
                    raise ValueError(
                        f"Reference alleles do not match: '{ref_allele}' "
                        f"and '{alleles[0]}'")
            else:
                ref_allele = alleles[0]
            all_alleles.update(alleles[1:])
    if ref_allele is None:
        raise ValueError("No reference allele found")

    sorted_alleles = sorted(all_alleles, key=lambda a: (len(a), a))
    sorted_alleles.insert(0, ref_allele)
    allele_to_index = {a: i for i, a in enumerate(sorted_alleles)}

    out_gts = []
    for i, vcf_gt in enumerate(vcf_gts):
        out_vcf = []
        for sample_gt in vcf_gt:
            s_gt = []
            for idx, phased in sample_gt:
                if idx is None:
                    s_gt.append((None, phased))
                else:
                    if idx >= len(sample_alleles[i]):
                        raise ValueError(f"Index out of range: {idx}")
                    allele = sample_alleles[i][idx]
                    if allele not in allele_to_index:
                        raise ValueError(
                            f"Allele not found in index: {allele!r}")
                    s_gt.append((allele_to_index[allele], phased))
            out_vcf.append(s_gt)
        out_gts.append(out_vcf)
    return out_gts, sorted_alleles
