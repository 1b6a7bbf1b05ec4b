"""BAM reader with BAI random access (replaces htslib BAM input).

Parses BAM headers/records and the .bai index directly (SAM spec §4);
`BamReader.fetch` mirrors htslib's indexed region fetch used by the
reference at src/trgt/workflows/tr.rs:277-309.
"""

import struct
from typing import Dict, Iterator, List, Optional, Tuple

from .bgzf import BgzfReader

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"
# packed-byte → two-character decode table (fast seq decoding)
_PAIR_TABLE = [SEQ_NT16[b >> 4] + SEQ_NT16[b & 0xF] for b in range(256)]

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


class BamRecord:
    __slots__ = ("ref_id", "pos", "mapq", "flag", "qname", "cigar", "seq",
                 "qual", "aux_raw", "_aux_cache")

    def __init__(self, ref_id, pos, mapq, flag, qname, cigar, seq, qual,
                 aux_raw):
        self.ref_id = ref_id
        self.pos = pos
        self.mapq = mapq
        self.flag = flag
        self.qname = qname
        self.cigar = cigar            # list[(length:int, op:str)]
        self.seq = seq                # str, upper-case
        self.qual = qual              # bytes (phred, no +33)
        self.aux_raw = aux_raw        # raw aux bytes
        self._aux_cache = None

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    def reference_end(self) -> int:
        end = self.pos
        for length, op in self.cigar:
            if op in "MDN=X":
                end += length
        return end

    def aux(self) -> Dict[str, object]:
        if self._aux_cache is None:
            self._aux_cache = parse_aux(self.aux_raw)
        return self._aux_cache

    def get_tag(self, tag: str):
        return self.aux().get(tag)


def parse_aux(data: bytes) -> Dict[str, object]:
    out: Dict[str, object] = {}
    pos = 0
    n = len(data)
    while pos + 3 <= n:
        tag = data[pos:pos + 2].decode("ascii")
        typ = chr(data[pos + 2])
        pos += 3
        if typ == "A":
            out[tag] = chr(data[pos]); pos += 1
        elif typ == "c":
            out[tag] = struct.unpack_from("<b", data, pos)[0]; pos += 1
        elif typ == "C":
            out[tag] = struct.unpack_from("<B", data, pos)[0]; pos += 1
        elif typ == "s":
            out[tag] = struct.unpack_from("<h", data, pos)[0]; pos += 2
        elif typ == "S":
            out[tag] = struct.unpack_from("<H", data, pos)[0]; pos += 2
        elif typ == "i":
            out[tag] = struct.unpack_from("<i", data, pos)[0]; pos += 4
        elif typ == "I":
            out[tag] = struct.unpack_from("<I", data, pos)[0]; pos += 4
        elif typ == "f":
            out[tag] = struct.unpack_from("<f", data, pos)[0]; pos += 4
        elif typ in "ZH":
            endp = data.index(0, pos)
            out[tag] = data[pos:endp].decode("ascii")
            pos = endp + 1
        elif typ == "B":
            sub = chr(data[pos]); pos += 1
            count = struct.unpack_from("<I", data, pos)[0]; pos += 4
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H",
                   "i": "i", "I": "I", "f": "f"}[sub]
            vals = list(struct.unpack_from(f"<{count}{fmt}", data, pos))
            pos += count * struct.calcsize(fmt)
            out[tag] = (sub, vals)
        else:
            raise ValueError(f"Unknown aux type {typ} for tag {tag}")
    return out


class BamHeader:
    def __init__(self, text: str, references: List[Tuple[str, int]]):
        self.text = text
        self.references = references  # [(name, length)]
        self._name_to_tid = {name: i for i, (name, _) in enumerate(references)}

    def tid(self, name: str) -> Optional[int]:
        return self._name_to_tid.get(name)

    def is_mapped(self) -> bool:
        # ref: src/utils/bam_utils.rs:11-19
        return any(line.startswith("@SQ") for line in self.text.splitlines()) \
            or bool(self.references)

    def sample_names(self) -> List[str]:
        names = set()
        for line in self.text.splitlines():
            if line.startswith("@RG"):
                for field in line.split("\t")[1:]:
                    if field.startswith("SM:"):
                        names.add(field[3:])
        return sorted(names)


def _parse_record(buf: bytes) -> Tuple[BamRecord, int]:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHIiii", buf, 0)
    p = 32
    qname = buf[p:p + l_read_name - 1].decode("ascii")
    p += l_read_name
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", buf, p)[0]
        cigar.append((v >> 4, CIGAR_OPS[v & 0xF]))
        p += 4
    nbytes = (l_seq + 1) // 2
    raw_seq = buf[p:p + nbytes]
    seq = "".join(map(_PAIR_TABLE.__getitem__, raw_seq))[:l_seq]
    p += nbytes
    qual = buf[p:p + l_seq]
    p += l_seq
    aux_raw = buf[p:]
    return BamRecord(ref_id, pos, mapq, flag, qname, cigar, seq, qual,
                     aux_raw)


def _reg2bins(beg: int, end: int) -> List[int]:
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise IOError("Invalid BAI magic")
        pos = 4
        n_ref = struct.unpack_from("<i", data, pos)[0]; pos += 4
        self.refs = []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, pos)[0]; pos += 4
            bins: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, pos)
                pos += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, pos)
                    pos += 16
                    chunks.append((beg, end))
                bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, pos)[0]; pos += 4
            ioffsets = list(struct.unpack_from(f"<{n_intv}Q", data, pos))
            pos += n_intv * 8
            self.refs.append((bins, ioffsets))

    def chunks_for(self, tid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        if tid < 0 or tid >= len(self.refs):
            return []
        bins, ioffsets = self.refs[tid]
        min_offset = 0
        iv = beg >> 14
        if iv < len(ioffsets):
            min_offset = ioffsets[iv]
        chunks = []
        for bin_id in _reg2bins(beg, end):
            for c in bins.get(bin_id, ()):
                if c[1] > min_offset:
                    chunks.append(c)
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for beg_v, end_v in chunks:
            if merged and beg_v <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], end_v))
            else:
                merged.append((beg_v, end_v))
        return merged


class BamReader:
    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise IOError(f"Not a BAM file: {path}")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        text = self._bgzf.read(l_text).split(b"\0")[0].decode("utf-8")
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        references = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            name = self._bgzf.read(l_name)[:-1].decode("ascii")
            l_ref = struct.unpack("<i", self._bgzf.read(4))[0]
            references.append((name, l_ref))
        self.header = BamHeader(text, references)
        self._body_voffset = self._bgzf.tell_virtual()
        self._index: Optional[BaiIndex] = None

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _load_index(self) -> BaiIndex:
        if self._index is None:
            import os
            for cand in (self.path + ".bai",
                         os.path.splitext(self.path)[0] + ".bai"):
                if os.path.exists(cand):
                    self._index = BaiIndex(cand)
                    break
            else:
                raise IOError(f"BAM index not found for {self.path}")
        return self._index

    def _read_record(self) -> Optional[BamRecord]:
        size_raw = self._bgzf.read(4)
        if len(size_raw) < 4:
            return None
        block_size = struct.unpack("<i", size_raw)[0]
        buf = self._bgzf.read(block_size)
        if len(buf) < block_size:
            raise IOError("Truncated BAM record")
        return _parse_record(buf)

    def __iter__(self) -> Iterator[BamRecord]:
        self._bgzf.seek_virtual(self._body_voffset)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    def fetch(self, contig: str, beg: int, end: int) -> Iterator[BamRecord]:
        """Yield records overlapping [beg, end) on contig."""
        tid = self.header.tid(contig)
        if tid is None:
            return
        index = self._load_index()
        for chunk_beg, chunk_end in index.chunks_for(tid, beg, end):
            self._bgzf.seek_virtual(chunk_beg)
            while self._bgzf.tell_virtual() < chunk_end:
                rec = self._read_record()
                if rec is None:
                    break
                if rec.ref_id != tid or rec.pos >= end:
                    break
                if rec.is_unmapped:
                    continue
                if rec.reference_end() > beg:
                    yield rec
