"""Length-based genotyper (ref: src/trgt/genotype/genotype_size.rs,
diploid.rs, haploid.rs).

The diploid penalty search is an exhaustive scan over (short, long) length
pairs — expressed as a vectorized penalty matrix so the same math runs
batched on device for many loci at once (kernels side) or via numpy here.
"""

from typing import List, Sequence, Tuple

import numpy as np

from . import consensus
from .gt import Gt, TrSize
from ..utils import Ploidy


def genotype(ploidy: Ploidy, seqs: Sequence[str],
             aligner=consensus.align_batch) -> Tuple[Gt, List[str], List[int]]:
    # ref: genotype_size.rs:6-64
    unique_lens, len_counts = _len_hist(seqs)

    if ploidy == Ploidy.ZERO:
        raise ValueError("Can't genotype repeats of zero ploidy")
    if ploidy == Ploidy.ONE:
        gt = haploid_genotype(unique_lens, len_counts)
    else:
        gt = diploid_genotype(unique_lens, len_counts)

    allele_lens = [a.size for a in gt]
    unique_seqs, counts = _seq_hist(seqs)
    alleles = consensus.get_consensus(allele_lens, unique_seqs, counts)
    seqs_by_allele = _split(allele_lens, unique_seqs, counts)

    fixed_alleles = []
    for index, allele in enumerate(alleles):
        a_seqs, a_counts = seqs_by_allele[index]
        coverage = sum(a_counts)
        reference_count = 0
        for s, c in zip(a_seqs, a_counts):
            if s == allele:
                reference_count = c
                break
        if 2 * reference_count >= coverage:
            fixed_alleles.append(allele)
        else:
            aligns = aligner(allele, a_seqs)
            fixed_alleles.append(
                consensus.repair_consensus(allele, a_seqs, aligns))
    alleles = fixed_alleles

    if ploidy == Ploidy.TWO and len(alleles) == 1:
        alleles.append(alleles[0])

    classifications = [0] * len(seqs)
    tie_breaker = 1
    for i, seq in enumerate(seqs):
        if len(alleles) == 2:
            diff1 = abs(len(seq) - len(alleles[0]))
            diff2 = abs(len(seq) - len(alleles[1]))
            if diff1 < diff2:
                classifications[i] = 0
            elif diff1 > diff2:
                classifications[i] = 1
            else:
                tie_breaker = (tie_breaker + 1) % 2
                classifications[i] = tie_breaker

    return gt, alleles, classifications


def _len_hist(seqs: Sequence[str]) -> Tuple[List[int], List[int]]:
    lens = sorted(len(s) for s in seqs)
    unique, counts = [], []
    for ln in lens:
        if unique and unique[-1] == ln:
            counts[-1] += 1
        else:
            unique.append(ln)
            counts.append(1)
    return unique, counts


def _seq_hist(seqs: Sequence[str]) -> Tuple[List[str], List[int]]:
    ordered = sorted(seqs)
    unique, counts = [], []
    for s in ordered:
        if unique and unique[-1] == s:
            counts[-1] += 1
        else:
            unique.append(s)
            counts.append(1)
    return unique, counts


def _split(allele_lens: Sequence[int], seqs: Sequence[str],
           counts: Sequence[int]):
    # ref: genotype_size.rs:96-131
    if len(allele_lens) == 1:
        return [(list(seqs), list(counts))]
    al1, al2 = allele_lens
    al1_seqs, al1_counts, al2_seqs, al2_counts = [], [], [], []
    for s, c in zip(seqs, counts):
        if abs(len(s) - al1) <= abs(len(s) - al2):
            al1_seqs.append(s)
            al1_counts.append(c)
        if abs(len(s) - al2) < abs(len(s) - al1):
            al2_seqs.append(s)
            al2_counts.append(c)
    return [(al1_seqs, al1_counts), (al2_seqs, al2_counts)]


def diploid_penalty_matrix(sizes: np.ndarray,
                           counts: np.ndarray) -> np.ndarray:
    """Vectorized penalty over all (short_idx, long_idx) pairs
    (ref: diploid.rs:51-84).

    Stays host numpy — the
    measured decision (benchmarks/genotyper_math.py): at the real
    per-locus sizes (median n ≈ 10-40 distinct lengths) numpy finishes
    in ~30-350 µs, under even a LOCAL jit dispatch, and three orders
    below the remote-TPU dispatch+fetch floor. The short-axis is
    evaluated in blocks so the (block, n, n) temporaries stay bounded
    at large n (the per-cell reduction is row-independent, so blocking
    does not change any float accumulation order — results are
    bit-identical to the unblocked expression)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.float64)
    n = len(sizes)
    # per-read term: 0 if size == allele else 10 + 2*|allele - size|
    diff = np.abs(sizes[:, None] - sizes[None, :])          # (allele, read)
    term = np.where(diff == 0, 0, 10 + 2 * diff).astype(np.float64)
    expansion = np.abs(sizes[:, None] - sizes[None, :]) > 100
    max_frac = np.where(expansion, 0.05, 0.25)[:, :, None]
    out = np.empty((n, n), dtype=np.float64)
    bs = max(1, int(4e6 // max(n * n, 1)))
    for lo_i in range(0, n, bs):
        hi_i = min(lo_i + bs, n)
        short_t = term[lo_i:hi_i, None, :]                  # (b, 1, read)
        long_t = term[None, :, :]                           # (1, l, read)
        lo = np.minimum(short_t, long_t)
        hi = np.maximum(short_t, long_t)
        per_read = lo + max_frac[lo_i:hi_i] * hi
        out[lo_i:hi_i] = (per_read * counts[None, None, :]).sum(axis=2)
    return out


def diploid_genotype(sizes: Sequence[int], counts: Sequence[int]) -> Gt:
    # ref: diploid.rs:5-49
    sizes_a = np.asarray(sizes, dtype=np.int64)
    counts_a = np.asarray(counts, dtype=np.int64)
    n = len(sizes)
    pen = diploid_penalty_matrix(sizes_a, counts_a)
    # candidates are pairs with short_index <= long_index; the reference's
    # stable sort keeps the first-minimal pair in enumeration order
    best = None
    for si in range(n):
        for li in range(si, n):
            p = pen[si, li]
            if best is None or p < best[0]:
                best = (p, sizes[si], sizes[li])
    _, short_size, long_size = best
    short_size, long_size = min(short_size, long_size), max(short_size,
                                                            long_size)

    if short_size != long_size and n >= 2:
        coverage = int(counts_a.sum())
        # hist sorted by count desc (stable on ties, matching
        # sorted_by(b.1.cmp(a.1)))
        order = sorted(range(n), key=lambda i: -counts[i])
        top_idx = order[0]
        top_frac = counts[top_idx] / coverage
        rng = max(sizes) - min(sizes)
        if top_frac > 0.60 and rng <= 6:
            short_size = long_size = sizes[top_idx]

    short_ci, long_ci = _get_ci((short_size, long_size), sizes)
    return [TrSize(short_size, short_ci), TrSize(long_size, long_ci)]


def _get_ci(gt: Tuple[int, int], sizes: Sequence[int]):
    # ref: diploid.rs:86-103
    short_size, long_size = gt
    short_ci = [short_size, short_size]
    long_ci = [long_size, long_size]
    for size in sizes:
        if abs(size - short_size) <= abs(size - long_size):
            short_ci = [min(short_ci[0], size), max(short_ci[1], size)]
        else:
            long_ci = [min(long_ci[0], size), max(long_ci[1], size)]
    return tuple(short_ci), tuple(long_ci)


def haploid_genotype(sizes: Sequence[int], counts: Sequence[int]) -> Gt:
    # ref: haploid.rs:3-30
    sizes_a = np.asarray(sizes, dtype=np.int64)
    counts_a = np.asarray(counts, dtype=np.float64)
    diff = np.abs(sizes_a[:, None] - sizes_a[None, :])
    term = np.where(diff == 0, 0.0, 10.0 + 2.0 * diff)
    penalties = (term * counts_a[None, :]).sum(axis=1)
    best_index = int(np.argmin(penalties))  # first minimum, like stable sort
    ci = (min(sizes), max(sizes))
    return [TrSize(sizes[best_index], ci)]
