"""SNP/HP-based flank genotyper (ref: src/trgt/genotype/genotype_flank.rs).

Uses haplotype tags when available, else phases reads by flanking SNVs;
the diplotype log-likelihood scoring is a small masked sum (device-friendly
but tiny — kept on host)."""

import math
from bisect import bisect_left
from typing import List, Optional, Sequence, Tuple

from . import consensus
from .gt import Gt, TrSize

Profile = List[Optional[bool]]


def genotype(reads, tr_seqs: Sequence[str],
             aligner=consensus.align_batch):
    # ref: genotype_flank.rs:9-41
    res = _get_trs_with_hp(reads, tr_seqs)
    if res is None:
        res = _get_trs_with_clustering(reads, tr_seqs)
    if res is None:
        return None
    trs_by_allele, allele_assignment = res

    gt: Gt = []
    alleles: List[str] = []
    for trs in trs_by_allele:
        sc = _simple_consensus(trs)
        if sc is None:
            return None
        backbone, frequency = sc
        MIN_FREQ_TO_ALIGN = 0.5
        if frequency < MIN_FREQ_TO_ALIGN:
            aligns = aligner(backbone, trs)
            allele = consensus.repair_consensus(backbone, trs, aligns)
        else:
            allele = backbone
        min_tr = min(len(t) for t in trs)
        max_tr = max(len(t) for t in trs)
        gt.append(TrSize(len(allele), (min_tr, max_tr)))
        alleles.append(allele)

    # Smaller allele first (genotype_flank.rs:34-38)
    if len(alleles[0]) > len(alleles[1]):
        gt.reverse()
        alleles.reverse()
        allele_assignment = [(a + 1) % 2 for a in allele_assignment]

    return gt, alleles, allele_assignment


def _get_trs_with_hp(reads, tr_seqs):
    # ref: genotype_flank.rs:43-76
    allele_assignment: List[int] = []
    trs_by_allele: List[List[str]] = [[], []]
    tie_breaker = 1
    num_unassigned = 0
    for read, tr_seq in zip(reads, tr_seqs):
        if read.hp_tag == 1:
            allele_assignment.append(0)
            trs_by_allele[0].append(tr_seq)
        elif read.hp_tag == 2:
            allele_assignment.append(1)
            trs_by_allele[1].append(tr_seq)
        else:
            tie_breaker = (tie_breaker + 1) % 2
            allele_assignment.append(tie_breaker)
            trs_by_allele[tie_breaker].append(tr_seq)
            num_unassigned += 1
    prop_assigned = (len(reads) - num_unassigned) / len(reads)
    if trs_by_allele[0] and trs_by_allele[1] and prop_assigned >= 0.7:
        return trs_by_allele, allele_assignment
    return None


def _get_trs_with_clustering(reads, tr_seqs):
    # ref: genotype_flank.rs:78-152
    if not tr_seqs:
        return None
    analysis_region = _get_analysis_region(reads)
    snvs = _call_snvs(analysis_region, reads, 0.20)
    profiles = _get_profiles(reads, snvs)
    candidate_gts = _get_candidate_gts(profiles)
    if len(candidate_gts) <= 1:
        return None

    best_gt = None
    best_ll = None
    for gt_c in candidate_gts:
        ll = _get_loglik(gt_c, profiles)
        # max_by keeps the LAST maximal element in Rust
        if best_ll is None or ll >= best_ll:
            best_ll = ll
            best_gt = gt_c
    if best_gt[0] == best_gt[1]:
        return None

    allele_assignment = []
    tie_breaker = 1
    trs_by_allele: List[List[str]] = [[], []]
    for index, profile in enumerate(profiles):
        dist1 = _get_dist(profile, best_gt[0])
        dist2 = _get_dist(profile, best_gt[1])
        if dist1 < dist2:
            allele_assignment.append(0)
            trs_by_allele[0].append(tr_seqs[index])
        elif dist1 > dist2:
            allele_assignment.append(1)
            trs_by_allele[1].append(tr_seqs[index])
        else:
            tie_breaker = (tie_breaker + 1) % 2
            allele_assignment.append(tie_breaker)
            trs_by_allele[0].append(tr_seqs[index])
            trs_by_allele[1].append(tr_seqs[index])
    return trs_by_allele, allele_assignment


def _get_dist(profile: Profile, allele: List[bool]) -> int:
    # ref: genotype_flank.rs:154-159 (counts matches despite the name)
    return sum(1 for p, h in zip(profile, allele) if p is not None and p == h)


def _simple_consensus(seqs: Sequence[str]):
    # ref: genotype_flank.rs:161-183 — most frequent sequence; ties broken
    # by length closest to median (BTreeMap iteration = sorted by seq)
    if not seqs:
        return None
    lens = sorted(len(s) for s in seqs)
    median_len = _median(lens)
    if median_len is None:
        return None
    seq_to_count = {}
    for s in seqs:
        seq_to_count[s] = seq_to_count.get(s, 0) + 1
    top = max(seq_to_count.values())
    best = None
    for s in sorted(seq_to_count):
        if seq_to_count[s] != top:
            continue
        delta = abs(len(s) - median_len)
        if best is None or delta < best[1]:
            best = (s, delta)
    return best[0], top / len(seqs)


def _median(sorted_vals: List[int]) -> Optional[int]:
    # ref: utils/math.rs:73-97 — f32 median (avg of middles when even),
    # truncated via `as usize` at genotype_flank.rs:162
    if not sorted_vals:
        return None
    n = len(sorted_vals)
    if n % 2 == 0:
        return (sorted_vals[n // 2 - 1] + sorted_vals[n // 2]) // 2
    return sorted_vals[n // 2]


def _get_loglik(gt, profiles) -> float:
    # ref: genotype_flank.rs:185-204
    total = 0.0
    for profile in profiles:
        t1 = _eval_profile_given_hap(profile, gt[0])
        t2 = _eval_profile_given_hap(profile, gt[1])
        total += _ln_sum_exp(t1, t2) - math.log(2.0)
    return total


def _eval_profile_given_hap(profile: Profile, hap: List[bool]) -> float:
    MATCH_PROB = 0.9
    MISMATCH_PROB = 1.0 - MATCH_PROB
    total = 0.0
    for p, h in zip(profile, hap):
        if p is None:
            continue
        total += math.log(MATCH_PROB if p == h else MISMATCH_PROB)
    return total


def _ln_sum_exp(t1: float, t2: float) -> float:
    m = max(t1, t2)
    return m + math.log(math.exp(t1 - m) + math.exp(t2 - m))


def _get_analysis_region(reads) -> Tuple[int, int]:
    # ref: genotype_flank.rs:206-226 — 85th-percentile read extents
    COV_READ_FRAC = 0.85
    skip_count = round(len(reads) * (1.0 - COV_READ_FRAC))
    starts = sorted(r.start_offset for r in reads)
    ends = sorted(r.end_offset for r in reads)
    # nth_back(skip) = element skip from the end
    start = starts[len(starts) - 1 - skip_count]
    end = ends[skip_count]
    return start, end


def _get_candidate_gts(profiles: Sequence[Profile]):
    # ref: genotype_flank.rs:228-252
    haps = sorted(
        (p for p in profiles if all(v is not None for v in p)),
        key=lambda p: [v for v in p])
    PUTATIVE_HAP_FRAC = 0.40
    if not profiles or len(haps) / len(profiles) < PUTATIVE_HAP_FRAC:
        return []
    dedup = []
    for h in haps:
        if not dedup or dedup[-1] != h:
            dedup.append(h)
    out = []
    for i, hap1 in enumerate(dedup):
        h1 = [v for v in hap1 if v is not None]
        for hap2 in dedup[i:]:
            h2 = [v for v in hap2 if v is not None]
            out.append((h1, h2))
    return out


def _get_profiles(reads, snvs: List[int]) -> List[Profile]:
    # ref: genotype_flank.rs:254-273
    profiles = []
    for read in reads:
        if read.mismatch_offsets is not None:
            mm = read.mismatch_offsets
            profile: Profile = []
            for snv in snvs:
                if snv < read.start_offset or snv > read.end_offset:
                    profile.append(None)
                else:
                    i = bisect_left(mm, snv)
                    profile.append(i < len(mm) and mm[i] == snv)
            profiles.append(profile)
        else:
            profiles.append([None] * len(snvs))
    return profiles


def _call_snvs(region: Tuple[int, int], reads,
               min_freq: float) -> List[int]:
    # ref: genotype_flank.rs:275-290
    counts = {}
    for r in reads:
        if r.mismatch_offsets is None:
            continue
        for offset in r.mismatch_offsets:
            if region[0] <= offset <= region[1]:
                counts[offset] = counts.get(offset, 0) + 1
    total_reads = len(reads)
    return sorted(off for off, c in counts.items()
                  if c / total_reads >= min_freq)
