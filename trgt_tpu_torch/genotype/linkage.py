"""Ward hierarchical clustering (replaces the kodama crate,
ref: src/trgt/genotype/genotype_cluster.rs:161).

NN-chain algorithm on a condensed distance matrix with Lance-Williams Ward
updates, followed by the standard sort+union-find relabeling, producing
steps identical to kodama/scipy: sorted by dissimilarity, clusters numbered
n..2n-2 in merge order, each step (cluster1, cluster2, dissimilarity, size)
with cluster1 < cluster2.
"""

import math
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Step:
    cluster1: int
    cluster2: int
    dissimilarity: float
    size: int


def condensed_index(n: int, i: int, j: int) -> int:
    if i > j:
        i, j = j, i
    return n * i - (i * (i + 1)) // 2 + (j - i - 1)


def ward_linkage(dists: np.ndarray, n: int) -> List[Step]:
    # square-form distance matrix for vectorized row operations;
    # inactive labels keep their row/column at +inf so the chain walk
    # below reads rows directly (no per-step masking — the masking
    # np.where was the targeted-preset hot spot)
    # np.empty+fill, NOT np.full: np.full's scalar-broadcast path is
    # ~100x slower on large arrays in this numpy build
    D = np.empty((n, n), dtype=np.float64)
    D.fill(np.inf)
    dists = np.asarray(dists, dtype=np.float64)
    pos = 0
    for i in range(n - 1):
        m = n - 1 - i
        D[i, i + 1:] = dists[pos:pos + m]
        D[i + 1:, i] = dists[pos:pos + m]
        pos += m

    size = np.ones(n, dtype=np.int64)
    active = np.ones(n, dtype=bool)
    merges = []  # (x_leafrep, y_leafrep, dist, new_size)
    chain = []

    for _ in range(n - 1):
        if not chain:
            x = int(np.argmax(active))
            chain.append(x)
        while True:
            x = chain[-1]
            row = D[x]                      # diag and inactive are +inf
            if len(chain) > 1:
                y = chain[-2]
                current_min = row[y]
                # strict < keeps the lowest-index NN on ties, preferring
                # the chain predecessor (matches scalar nn-chain)
                cand = int(np.argmin(row))
                if row[cand] < current_min:
                    y = cand
                    current_min = row[cand]
            else:
                y = int(np.argmin(row))
                current_min = row[y]
            if len(chain) > 1 and y == chain[-2]:
                break
            chain.append(y)
        chain.pop()
        chain.pop()
        if x > y:
            x, y = y, x
        nx, ny = int(size[x]), int(size[y])
        merges.append((x, y, float(current_min), nx + ny))
        # Lance-Williams Ward update into label y (vectorized)
        d_xy2 = current_min * current_min
        mask = active.copy()
        mask[x] = mask[y] = False
        ni = size[mask].astype(np.float64)
        d_xi = D[x, mask]
        d_yi = D[y, mask]
        val = ((nx + ni) * d_xi * d_xi + (ny + ni) * d_yi * d_yi
               - ni * d_xy2) / (nx + ny + ni)
        new_row = np.sqrt(np.maximum(val, 0.0))
        D[y, mask] = new_row
        D[mask, y] = new_row
        active[x] = False
        size[x] = 0
        size[y] = nx + ny
        D[x, :] = np.inf
        D[:, x] = np.inf

    # sort by dissimilarity (stable) + union-find relabel (kodama/scipy
    # `label` step: clusters numbered n..2n-2 in sorted order)
    order = sorted(range(n - 1), key=lambda k: merges[k][2])
    parent = list(range(2 * n - 1))

    def find(a: int) -> int:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    steps: List[Step] = []
    for i, k in enumerate(order):
        x, y, dist, sz = merges[k]
        rx, ry = find(x), find(y)
        if rx > ry:
            rx, ry = ry, rx
        steps.append(Step(rx, ry, dist, sz))
        parent[rx] = parent[ry] = n + i
    return steps


def cluster_size(steps: List[Step], n: int, node: int) -> int:
    # kodama Dendrogram::cluster_size semantics
    if node < n:
        return 1
    return steps[node - n].size
