"""HiFi read representation (ref: src/trgt/reads/read.rs, cigar.rs, snp.rs)."""

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..utils import GenomicRegion

CigarOp = Tuple[int, str]  # (length, op char)

_REF_CONSUMERS = frozenset("MDN=X")
_QUERY_CONSUMERS = frozenset("MI=XS")


def op_ref_len(op: CigarOp) -> int:
    return op[0] if op[1] in _REF_CONSUMERS else 0


def op_query_len(op: CigarOp) -> int:
    return op[0] if op[1] in _QUERY_CONSUMERS else 0


@dataclass
class Cigar:
    ref_pos: int
    ops: List[CigarOp]

    def query_len(self) -> int:
        return sum(op_query_len(op) for op in self.ops)

    def reference_end(self) -> int:
        return self.ref_pos + sum(op_ref_len(op) for op in self.ops)


@dataclass
class HiFiRead:
    id: str
    is_reverse: bool
    bases: bytes
    quals: bytes
    meth: Optional[bytes]              # per-CpG 0..255 probabilities
    read_qual: Optional[float]         # rq tag
    mismatch_offsets: Optional[List[int]]
    start_offset: int
    end_offset: int
    cigar: Optional[Cigar]
    hp_tag: Optional[int]
    mapq: int

    @classmethod
    def from_bam_rec(cls, rec, region: GenomicRegion) -> "HiFiRead":
        # ref: src/trgt/reads/read.rs:101-141
        bases = rec.seq.encode("ascii")
        cigar = None
        if not rec.is_unmapped:
            cigar = Cigar(ref_pos=rec.pos, ops=list(rec.cigar))
        meth = extract_meth(rec, bases)
        aux = rec.aux()
        rq = aux.get("rq")
        read_qual = float(rq) if isinstance(rq, float) else None
        hp = aux.get("HP")
        hp_tag = hp if isinstance(hp, int) else None
        start_offset = rec.pos - region.start
        ref_end = rec.reference_end() if cigar else rec.pos
        end_offset = ref_end - region.end
        mismatch_offsets = (extract_snps_offset(cigar, region)
                            if cigar is not None else None)
        return cls(
            id=rec.qname,
            is_reverse=rec.is_reverse,
            bases=bases,
            quals=bytes(rec.qual),
            meth=meth,
            read_qual=read_qual,
            mismatch_offsets=mismatch_offsets,
            start_offset=start_offset,
            end_offset=end_offset,
            cigar=cigar,
            hp_tag=hp_tag,
            mapq=rec.mapq,
        )


def extract_snps_offset(cigar: Cigar, region: GenomicRegion) -> List[int]:
    # ref: src/trgt/reads/snp.rs:51-78 — mismatch ref-positions outside the
    # region, as offsets from region start (if before) or end (if after)
    mismatches: List[int] = []
    start_ref = cigar.ref_pos
    for length, op in cigar.ops:
        if op == "X" and not region.intersect_position(start_ref):
            if start_ref < region.start:
                diff = start_ref - region.start
            else:
                diff = start_ref - region.end
            mismatches.extend(diff + i for i in range(length))
            start_ref += length
        elif op in _REF_CONSUMERS:
            start_ref += length
    return mismatches


def _mods_from_mm_ml(rec, bases: bytes):
    """Decode MM/ML tags into (pos_in_stored_seq, qual) for C+m mods.

    Reimplements htslib's basemods parsing (used via rec.basemods_iter() at
    src/trgt/reads/read.rs:69): MM skip-counts refer to the original read
    orientation; for reverse-strand alignments the stored sequence is the
    reverse complement, so positions are mapped back accordingly.
    """
    aux = rec.aux()
    mm = aux.get("MM")
    if mm is None:
        mm = aux.get("Mm")
    ml = aux.get("ML")
    if ml is None:
        ml = aux.get("Ml")
    if not isinstance(mm, str) or mm == "":
        return None
    ml_vals = ml[1] if isinstance(ml, tuple) else []
    reverse = rec.is_reverse
    out = []
    ml_index = 0
    ok = False
    for item in mm.rstrip(";").split(";"):
        if not item:
            continue
        parts = item.split(",")
        head = parts[0]
        m = re.match(r"^([ACGTUN])([-+])([a-zA-Z]+|[0-9]+)([.?]?)$", head)
        if m is None:
            return None  # malformed MM — htslib yields error → None
        canonical, _strand, mods, _flag = m.groups()
        deltas = [int(x) for x in parts[1:]]
        n_mods = 1 if mods.isdigit() else len(mods)
        # positions of canonical base in ORIGINAL read orientation
        if reverse:
            comp = {"A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
                    "N": "N"}[canonical]
            canon_positions = [i for i in range(len(bases))
                               if bases[len(bases) - 1 - i] == ord(comp)]
        else:
            canon_positions = [i for i in range(len(bases))
                               if bases[i] == ord(canonical) or
                               canonical == "N"]
        idx = -1
        for delta in deltas:
            idx += delta + 1
            if idx >= len(canon_positions):
                break
            orig_pos = canon_positions[idx]
            stored_pos = (len(bases) - 1 - orig_pos) if reverse else orig_pos
            for _ in range(n_mods):
                qual = ml_vals[ml_index] if ml_index < len(ml_vals) else 0
                ml_index += 1
                out.append((stored_pos, canonical, qual))
            ok = True
    if not ok and not out:
        return []
    return out


def extract_meth(rec, bases: bytes) -> Optional[bytes]:
    # ref: src/trgt/reads/read.rs:55-90 get_meth — project C+m calls onto
    # CpG sites of the stored sequence (G position for reverse reads)
    mods = _mods_from_mm_ml(rec, bases)
    if mods is None:
        return None
    reverse = rec.is_reverse
    cpg_indices = []
    start = 0
    while True:
        x = bases.find(b"CG", start)
        if x == -1:
            break
        cpg_indices.append(x + (1 if reverse else 0))
        start = x + 1
    num_cpgs = len(cpg_indices)
    ans = [0] * num_cpgs
    ind = 0
    mods_sorted = sorted((p, q) for (p, c, q) in mods if c == "C")
    for pos, qual in mods_sorted:
        while ind < num_cpgs and cpg_indices[ind] < pos:
            ind += 1
        if ind < num_cpgs and pos == cpg_indices[ind]:
            ans[ind] = qual
            ind += 1
    if ind == 0:
        # no mod call at or before a CpG — treated as empty MM/ML
        return None
    if reverse:
        ans.reverse()
    return bytes(ans)
