"""Consensus building (ref: src/trgt/genotype/consensus.rs)."""

from collections import Counter
from typing import List, Optional, Sequence, Tuple

from ..kernels.align_host import align_end_to_end

CigarOps = List[Tuple[int, str]]

_BASE_INDEX = {ord("A"): 0, ord("T"): 1, ord("C"): 2, ord("G"): 3}
_INDEX_BASE = "ATCG"


def align_batch(backbone: str, seqs: Sequence[str],
                scoring=(2, 5, 1)) -> List[CigarOps]:
    """Align each seq against the backbone (ref: src/utils/align.rs:14-28,
    consensus aligner affine(2,5,1)). Deduplicated: the alignment is a
    pure function of (backbone, seq), and deep loci repeat identical
    read sequences, so each distinct seq is aligned once and the CIGAR
    shared (identical output to the per-read loop)."""
    mism, gapo, gape = scoring
    bb = backbone.encode()
    cache = {}
    out = []
    for s in seqs:
        cig = cache.get(s)
        if cig is None:
            cig = align_end_to_end(bb, s.encode(), mism, gapo, gape)[1]
            cache[s] = cig
        out.append(cig)
    return out


def repair_consensus(reference: str, seqs: Sequence[str],
                     aligns: Sequence[CigarOps]) -> str:
    # ref: consensus.rs:5-72 — per-column base/deletion voting + majority
    # insertions. Vectorized: votes accumulate as numpy masked adds per
    # CIGAR run (sequential memory ops — fast on every machine), and
    # identical (seq, cigar) pairs are counted once with multiplicity
    # (alignment is pure, so deep loci's repeated reads share votes);
    # both changes are exact re-expressions of the per-base loop.
    import numpy as np

    R = len(reference)
    counts = np.zeros((R, 5), dtype=np.int64)
    ref_inserts: List[List[str]] = [[] for _ in range(R + 1)]

    groups: dict = {}
    for seq, operations in zip(seqs, aligns):
        key = (seq, id(operations))
        if key in groups:
            groups[key][2] += 1
        else:
            groups[key] = [seq, operations, 1]

    # byte -> vote column (A T C G), 255 = invalid (must raise below)
    col_lut = np.full(256, 255, dtype=np.uint8)
    for col, code in enumerate((65, 84, 67, 71)):
        col_lut[code] = col

    for seq, operations, mult in groups.values():
        seq_b = np.frombuffer(seq.encode(), dtype=np.uint8)
        x_pos = 0
        y_pos = 0
        for op_len, op in operations:
            if op in ("=", "M", "X"):
                chunk = seq_b[x_pos:x_pos + op_len]
                cols = col_lut[chunk]
                bad = np.nonzero(cols == 255)[0]
                if bad.size:
                    # parity with the dict-lookup loop: non-ATCG bases
                    # are a caller bug and must raise, not miscount
                    raise KeyError(int(chunk[bad[0]]))
                # one indexed add per run (row indices are unique, so
                # fancy-index += is exact)
                counts[y_pos + np.arange(op_len), cols] += mult
                x_pos += op_len
                y_pos += op_len
            elif op == "D":
                counts[y_pos:y_pos + op_len, 4] += mult
                y_pos += op_len
            elif op == "I":
                ref_inserts[y_pos].extend(
                    [seq[x_pos:x_pos + op_len]] * mult)
                x_pos += op_len
            else:
                raise ValueError(f"Unexpected CIGAR operation: {op}")

    # first maximum wins, matching max(range(5), key=...) semantics
    consensus_indexes = np.argmax(counts, axis=1)

    consensus = []
    for ref_pos in range(R):
        if len(ref_inserts[ref_pos]) > len(seqs) // 2:
            consensus.append(_ins_consensus(ref_inserts[ref_pos], len(seqs)))
        base_index = consensus_indexes[ref_pos]
        if base_index != 4:
            consensus.append(_INDEX_BASE[base_index])
    return "".join(consensus)


def _ins_consensus(ins_by_read: List[str], num_reads: int) -> str:
    # ref: consensus.rs:96-113 — most frequent insertion (ties: sorted order
    # puts the lexicographically smallest first), kept only if more reads
    # have it than lack any insertion
    ins_by_read = sorted(ins_by_read)
    reads_without_ins = num_reads - len(ins_by_read)
    groups: List[Tuple[str, int]] = []
    for ins in ins_by_read:
        if groups and groups[-1][0] == ins:
            groups[-1] = (ins, groups[-1][1] + 1)
        else:
            groups.append((ins, 1))
    # stable sort by count desc (matches itertools sorted_by on count)
    groups.sort(key=lambda g: -g[1])
    top_ins, ins_count = groups[0]
    return top_ins if ins_count > reads_without_ins else ""


def get_consensus(sizes: Sequence[int], seqs: Sequence[str],
                  counts: Sequence[int]) -> List[str]:
    # ref: consensus.rs:117-131
    consensuses = []
    allele = _closest_size(seqs, sizes[0])
    consensuses.append(_most_frequent_seq(seqs, counts, allele))
    if len(sizes) != 1 and sizes[0] != sizes[1]:
        allele = _closest_size(seqs, sizes[1])
        consensuses.append(_most_frequent_seq(seqs, counts, allele))
    return consensuses


def _closest_size(seqs: Sequence[str], allele: int) -> Optional[int]:
    # ref: consensus.rs:133-150
    closest = None
    for seq in seqs:
        read_len = len(seq)
        if closest is None:
            closest = read_len
            continue
        if abs(closest - allele) > abs(read_len - allele):
            closest = read_len
    return closest


def _most_frequent_seq(seqs: Sequence[str], counts: Sequence[int],
                       length: int) -> str:
    # ref: consensus.rs:152-163 — max_by_key keeps the LAST maximal element
    best_seq = None
    best_count = -1
    for seq, count in zip(seqs, counts):
        if len(seq) == length and count >= best_count:
            best_seq, best_count = seq, count
    assert best_seq is not None
    return best_seq
