"""Cluster genotyper (ref: src/trgt/genotype/genotype_cluster.rs).

Pairwise edit-distance matrix (device-batchable; host fallback here) →
Ward linkage (host, linkage.py) → dendrogram cutoff → per-group consensus.
"""

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import consensus
from .gt import Gt, TrSize
from .linkage import Step, cluster_size, condensed_index, ward_linkage
from ..kernels.align_host import edit_distance

# Pair-size ceiling above which the edit-distance DP is replaced by the
# length-difference lower bound (ref: genotype_cluster.rs:231-247)
MAX_OPS = 10000


def get_dist(seq1: bytes, seq2: bytes) -> float:
    seq_diff = abs(len(seq1) - len(seq2))
    if len(seq1) * len(seq2) > MAX_OPS:
        dist = seq_diff
    else:
        dist = edit_distance(seq1, seq2)
    return math.sqrt(float(dist))


def get_dist_matrix(trs: Sequence[bytes], pair_dists=None) -> np.ndarray:
    """Condensed pairwise distance matrix, filled row-vectorized (the
    O(n²) Python pair loop was the targeted-preset bottleneck). pair_dists optionally supplies precomputed raw edit
    distances: either a full (n, n) square matrix, or a deduplicated
    (ed_u, uidx) pair where ed_u is the (U, U) matrix over UNIQUE
    sequences and uidx maps each read to its unique id (edit distance
    is a pure function of the pair, so identical reads share entries —
    ref semantics genotype_cluster.rs:250-286 are unchanged)."""
    n = len(trs)
    if n < 2:
        return np.zeros(0, dtype=np.float64)
    dists = np.empty(n * (n - 1) // 2, dtype=np.float64)
    pos = 0
    if isinstance(pair_dists, tuple):
        ed_u, uidx = pair_dists
        for i in range(n - 1):
            m = n - 1 - i
            np.sqrt(ed_u[uidx[i], uidx[i + 1:]], out=dists[pos:pos + m])
            pos += m
    elif pair_dists is not None:
        for i in range(n - 1):
            m = n - 1 - i
            np.sqrt(np.asarray(pair_dists[i, i + 1:], dtype=np.float64),
                    out=dists[pos:pos + m])
            pos += m
    else:
        lens = np.array([len(t) for t in trs], dtype=np.int64)
        for i in range(n - 1):
            m = n - 1 - i
            row = np.abs(lens[i + 1:] - lens[i]).astype(np.float64)
            small = np.nonzero(lens[i] * lens[i + 1:] <= MAX_OPS)[0]
            for k in small:
                row[k] = edit_distance(trs[i], trs[i + 1 + k])
            np.sqrt(row, out=dists[pos:pos + m])
            pos += m
    return dists


def central_read(num_seqs: int, group: Sequence[int],
                 dists: np.ndarray) -> int:
    # ref: genotype_cluster.rs:12-39. Row-vectorized; float parity with
    # the reference's sequential `+=` accumulation is preserved exactly:
    # per element, the j-role additions arrive one per earlier row (in
    # ascending row order) and the i-role additions are applied by
    # np.add.at, which processes repeated indices sequentially in the
    # given (ascending j) order — the same addition sequence per element
    # as the reference's double loop.
    group_size = len(group)
    if group_size <= 2:
        return group[0]
    g = np.asarray(group, dtype=np.int64)
    dist_sums = np.zeros(group_size, dtype=np.float64)
    for i in range(group_size - 1):
        idx1 = int(g[i])
        mat = num_seqs * idx1 - idx1 * (idx1 + 3) // 2 + g[i + 1:] - 1
        vals = dists[mat]
        np.add.at(dist_sums, np.full(vals.size, i), vals)
        dist_sums[i + 1:] += vals
    best = min(range(group_size), key=lambda i: (dist_sums[i], i))
    return group[best]


def make_consensus(num_seqs: int, trs: Sequence[bytes], dists: np.ndarray,
                   group: Sequence[int],
                   aligner=consensus.align_batch) -> Tuple[str, TrSize]:
    # ref: genotype_cluster.rs:41-56
    seqs = [trs[i].decode() for i in group]
    backbone = trs[central_read(num_seqs, group, dists)].decode()
    aligns = aligner(backbone, seqs)
    allele = consensus.repair_consensus(backbone, seqs, aligns)
    size = TrSize(len(allele), (min(len(s) for s in seqs),
                                max(len(s) for s in seqs)))
    return allele, size


def cluster(num_seqs: int, dists: np.ndarray) -> List[List[int]]:
    # ref: genotype_cluster.rs:154-227
    assert num_seqs >= 2
    assert num_seqs * (num_seqs - 1) // 2 == len(dists)
    if num_seqs == 2:
        return [[0], [1]]

    steps = ward_linkage(dists, num_seqs)
    cutoff = 0.0
    MIN_SMALLER_FRAC = 0.01
    MIN_CLUSTER_SIZE = 2
    min_cluster_size = max(MIN_CLUSTER_SIZE,
                           round(MIN_SMALLER_FRAC * num_seqs))
    for step in reversed(steps):
        size1 = cluster_size(steps, num_seqs, step.cluster1)
        size2 = cluster_size(steps, num_seqs, step.cluster2)
        if min(size1, size2) >= min_cluster_size:
            cutoff = step.dissimilarity - 0.0001
            break

    if cutoff == 0.0:
        return [list(range(0, num_seqs, 2)), list(range(1, num_seqs, 2))]

    num_groups = 0
    num_nodes = 2 * num_seqs - 1
    membership: List[Optional[int]] = [None] * num_nodes
    for cluster_index in range(len(steps) - 1, -1, -1):
        step = steps[cluster_index]
        node = cluster_index + num_seqs
        if step.dissimilarity <= cutoff:
            if membership[node] is None:
                membership[node] = num_groups
                num_groups += 1
            membership[step.cluster1] = membership[node]
            membership[step.cluster2] = membership[node]

    groups = []
    for g in membership[:num_seqs]:
        if g is not None:
            groups.append(g)
        else:
            groups.append(num_groups)
            num_groups += 1

    seqs_by_group: List[List[int]] = [[] for _ in range(num_groups)]
    for seq_index, g in enumerate(groups):
        seqs_by_group[g].append(seq_index)
    return seqs_by_group


def genotype(ploidy, trs: Sequence[str], pair_dists=None,
             aligner=consensus.align_batch) -> Tuple[Gt, List[str], List[int]]:
    # ref: genotype_cluster.rs:58-152
    from ..utils import Ploidy
    trs_b = [t.encode() for t in trs]
    dists = get_dist_matrix(trs_b, pair_dists)
    num_seqs = len(trs_b)

    if ploidy == Ploidy.ONE or num_seqs == 1:
        group = list(range(num_seqs))
        allele, size = make_consensus(num_seqs, trs_b, dists, group, aligner)
        classifications = [0] * num_seqs
        if ploidy == Ploidy.ONE:
            return [size], [allele], classifications
        return [size, TrSize(size.size, size.ci)], [allele, allele], \
            classifications

    groups = cluster(num_seqs, dists)
    assert len(groups) >= 2
    groups.sort(key=len)
    group1 = groups.pop()
    group2 = groups.pop()

    allele1, size1 = make_consensus(num_seqs, trs_b, dists, group1, aligner)
    allele2, size2 = make_consensus(num_seqs, trs_b, dists, group2, aligner)

    def small_group_is_outlier(len1, len2, cov1, cov2):
        MIN_LEN_DIFF = 100
        MIN_COV_RATIO = 4
        return (abs(len1 - len2) < MIN_LEN_DIFF
                and min(cov1, cov2) * MIN_COV_RATIO < max(cov1, cov2))

    if small_group_is_outlier(len(allele1), len(allele2), len(group1),
                              len(group2)):
        # redo as homozygous (genotype_cluster.rs:96-110)
        group1 = list(range(0, num_seqs, 2))
        group2 = list(range(1, num_seqs, 2))
        allele1, size1 = make_consensus(num_seqs, trs_b, dists, group1,
                                        aligner)
        allele2, size2 = make_consensus(num_seqs, trs_b, dists, group2,
                                        aligner)
        classifications = [i % 2 for i in range(num_seqs)]
        if len(allele1) > len(allele2):
            classifications = [1 - c for c in classifications]
            return [size2, size1], [allele2, allele1], classifications
        return [size1, size2], [allele1, allele2], classifications

    classifications = [2] * num_seqs
    for i in group1:
        classifications[i] = 0
    for i in group2:
        classifications[i] = 1

    # assign outlier reads to the closest consensus
    # NOTE (ref quirk): the tie_breaker resets to 1 inside the loop at
    # genotype_cluster.rs:122, so ties always assign allele 0
    a1, a2 = allele1.encode(), allele2.encode()
    for i in range(num_seqs):
        tie_breaker = 1
        if classifications[i] == 2:
            dist1 = _outlier_dist(trs_b[i], a1)
            dist2 = _outlier_dist(trs_b[i], a2)
            if dist1 < dist2:
                classifications[i] = 0
            elif dist2 < dist1:
                classifications[i] = 1
            else:
                tie_breaker = (tie_breaker + 1) % 2
                classifications[i] = tie_breaker

    if len(allele1) > len(allele2):
        classifications = [1 - c for c in classifications]
        return [size2, size1], [allele2, allele1], classifications
    return [size1, size2], [allele1, allele2], classifications


def _outlier_dist(seq1: bytes, seq2: bytes) -> float:
    return get_dist(seq1, seq2)
