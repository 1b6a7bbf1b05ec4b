"""Read clipping (ref: src/trgt/reads/clip_region.rs, clip_bases.rs)."""

from dataclasses import replace
from typing import List, Optional, Tuple

from .hifi_read import Cigar, CigarOp, HiFiRead, op_query_len, op_ref_len

_SPLIT_REF_OPS = frozenset("MND=X")     # ref-consuming ops splittable by ref len
_SPLIT_QUERY_OPS = frozenset("MIX=S")   # query-consuming ops


def _clip_meth(bases: bytes, meth: Optional[bytes], region_start: int,
               region_end: int) -> Optional[bytes]:
    # ref: clip_region.rs:40-58 / clip_bases.rs:22-40 — walk CpG sites, keep
    # profile entries whose C index lies in [region_start, region_end).
    # Vectorized (the per-base Python loop was a writer-path hotspot at
    # the 10^4-locus scale): CG ordinals stand in for meth_index, so the
    # result is byte-identical to the scan, including the
    # meth-shorter-than-CG-count truncation.
    if meth is None:
        return None
    import numpy as np
    arr = np.frombuffer(bases, dtype=np.uint8)
    if arr.size < 2:
        return b""
    cg = np.nonzero((arr[:-1] == 0x43) & (arr[1:] == 0x47))[0]  # C, G
    ordinals = np.nonzero((cg >= region_start) & (cg < region_end))[0]
    ordinals = ordinals[ordinals < len(meth)]
    if isinstance(meth, (bytes, bytearray)):
        mv = np.frombuffer(bytes(meth), dtype=np.uint8)
    else:
        mv = np.asarray(meth, dtype=np.uint8)
    return mv[ordinals].tobytes()


def _clip_cigar_to_region(cigar: Cigar,
                          region: Tuple[int, int]
                          ) -> Optional[Tuple[int, int, List[CigarOp]]]:
    # ref: clip_region.rs:105-190 clip_cigar
    region_start, region_end = region
    read_start = cigar.ref_pos
    read_end = cigar.reference_end()
    if read_end <= region_start or region_end <= read_start:
        return None

    ref_pos = cigar.ref_pos
    query_pos = 0
    ops = list(cigar.ops)
    i = 0
    clipped_ops: List[CigarOp] = []

    # Skip operations entirely left of the region
    while i < len(ops) and ref_pos + op_ref_len(ops[i]) <= region_start:
        ref_pos += op_ref_len(ops[i])
        query_pos += op_query_len(ops[i])
        i += 1

    clipped_ref_start = ref_pos
    clipped_query_start = query_pos

    # Split the operation overlapping the left boundary
    if ref_pos < region_start:
        op_len, op_char = ops[i]
        if op_char not in _SPLIT_REF_OPS:
            raise ValueError(f"Unexpected operation {ops[i]!r}")
        ref_outside_len = region_start - ref_pos
        op_ref = op_ref_len(ops[i])
        if ref_pos + op_ref <= region_end:
            clipped_len = op_ref - ref_outside_len
        else:
            clipped_len = region_end - region_start
        clipped_ops.append((clipped_len, op_char))
        clipped_ref_start += ref_outside_len
        if op_query_len(clipped_ops[-1]) != 0:
            clipped_query_start += ref_outside_len
        ref_pos += op_ref_len(ops[i])
        query_pos += op_query_len(ops[i])
        i += 1

    # Copy contained operations
    while i < len(ops) and ref_pos + op_ref_len(ops[i]) <= region_end:
        clipped_ops.append(ops[i])
        ref_pos += op_ref_len(ops[i])
        query_pos += op_query_len(ops[i])
        i += 1

    # Split the operation overlapping the right boundary
    if i < len(ops) and ref_pos < region_end:
        op_len, op_char = ops[i]
        if op_char not in _SPLIT_REF_OPS:
            raise ValueError(f"Unexpected operation {ops[i]!r}")
        clipped_ops.append((region_end - ref_pos, op_char))

    return clipped_ref_start, clipped_query_start, clipped_ops


def clip_to_region(read: HiFiRead,
                   region: Tuple[int, int]) -> Optional[HiFiRead]:
    # ref: clip_region.rs:19-74
    if read.cigar is None:
        return None
    clipped = _clip_cigar_to_region(read.cigar, region)
    if clipped is None:
        return None
    clipped_ref_start, clipped_query_start, clipped_ops = clipped

    clipped_bases = bytearray()
    clipped_quals = bytearray()
    query_pos = clipped_query_start
    for op in clipped_ops:
        qlen = op_query_len(op)
        clipped_bases += read.bases[query_pos:query_pos + qlen]
        clipped_quals += read.quals[query_pos:query_pos + qlen]
        query_pos += qlen
    clipped_query_end = query_pos

    clipped_meth = _clip_meth(read.bases, read.meth, clipped_query_start,
                              clipped_query_end)

    return replace(
        read,
        bases=bytes(clipped_bases),
        quals=bytes(clipped_quals),
        meth=clipped_meth,
        cigar=Cigar(ref_pos=clipped_ref_start, ops=clipped_ops),
    )


def _clip_cigar_bases(cigar: Cigar, left_len: int,
                      right_len: int) -> Optional[Cigar]:
    # ref: clip_bases.rs:63-127
    align_query_len = cigar.query_len()
    assert align_query_len >= left_len + right_len
    keep_len = align_query_len - left_len - right_len

    ops = list(cigar.ops)
    i = 0
    ref_pos = cigar.ref_pos

    while left_len != 0:
        qlen = op_query_len(ops[i])
        if qlen > left_len:
            leftover = qlen - left_len
            op_char = ops[i][1]
            if op_char not in _SPLIT_QUERY_OPS:
                raise ValueError(f"Unexpected operation {ops[i]!r}")
            ops[i] = (leftover, op_char)
            if op_ref_len(ops[i]) != 0:
                ref_pos += left_len
            left_len = 0
        else:
            left_len -= qlen
            ref_pos += op_ref_len(ops[i])
            i += 1

    clipped_ops: List[CigarOp] = []
    while i < len(ops) and keep_len != 0:
        qlen = op_query_len(ops[i])
        if qlen > keep_len:
            op_char = ops[i][1]
            if op_char not in _SPLIT_QUERY_OPS:
                raise ValueError(f"Unexpected operation {ops[i]!r}")
            clipped_ops.append((keep_len, op_char))
            keep_len = 0
        else:
            keep_len -= qlen
            clipped_ops.append(ops[i])
            i += 1

    return Cigar(ref_pos=ref_pos, ops=clipped_ops)


def clip_bases(read: HiFiRead, left_len: int,
               right_len: int) -> Optional[HiFiRead]:
    # ref: clip_bases.rs:9-56
    if left_len + right_len >= len(read.bases):
        return None
    clipped_bases = read.bases[left_len:len(read.bases) - right_len]
    clipped_quals = read.quals[left_len:len(read.quals) - right_len]
    clipped_cigar = (_clip_cigar_bases(read.cigar, left_len, right_len)
                     if read.cigar is not None else None)
    clipped_meth = _clip_meth(read.bases, read.meth, left_len,
                              len(read.bases) - right_len)
    return replace(
        read,
        bases=clipped_bases,
        quals=clipped_quals,
        meth=clipped_meth,
        cigar=clipped_cigar,
    )
