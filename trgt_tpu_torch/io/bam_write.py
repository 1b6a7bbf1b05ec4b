"""BAM writer (replaces htslib BAM output; ref: src/trgt/writers/write_bam.rs)."""

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .bgzf import BgzfWriter
from .bam import BamHeader, reg2bin, CIGAR_OPS

SEQ_NT16_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
CIGAR_OP_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}

# ASCII byte → 4-bit nibble code (unknown → 15 = N), upper+lower case
_NT16_TABLE = bytearray([15]) * 256
for _c, _i in SEQ_NT16_CODE.items():
    _NT16_TABLE[ord(_c)] = _i
    _NT16_TABLE[ord(_c.lower())] = _i
_NT16_TABLE = bytes(_NT16_TABLE)


def pack_seq(seq: str) -> bytes:
    """4-bit pack a sequence (vectorized; the per-record hot path)."""
    l_seq = len(seq)
    codes = seq.encode("ascii").translate(_NT16_TABLE)
    if l_seq % 2:
        codes += b"\0"
    arr = np.frombuffer(codes, dtype=np.uint8)
    return ((arr[0::2] << 4) | arr[1::2]).tobytes()


def encode_aux(tag: str, typ: str, value) -> bytes:
    out = tag.encode("ascii") + typ.encode("ascii")
    if typ == "A":
        return out + value.encode("ascii")
    if typ == "c":
        return out + struct.pack("<b", value)
    if typ == "C":
        return out + struct.pack("<B", value)
    if typ == "s":
        return out + struct.pack("<h", value)
    if typ == "S":
        return out + struct.pack("<H", value)
    if typ == "i":
        return out + struct.pack("<i", value)
    if typ == "I":
        return out + struct.pack("<I", value)
    if typ == "f":
        return out + struct.pack("<f", value)
    if typ in "ZH":
        return out + value.encode("ascii") + b"\0"
    if typ == "B":
        sub, vals = value
        dtype = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
                 "i": "<i4", "I": "<u4", "f": "<f4"}[sub]
        # accept numpy arrays/bytes directly — the long per-read arrays
        # (MO mismatch offsets, MC meth) dominate the aux path at scale
        if isinstance(vals, (bytes, bytearray)):
            arr = np.frombuffer(bytes(vals), dtype=dtype)
        else:
            arr = np.asarray(vals, dtype=dtype)
        return out + sub.encode("ascii") + struct.pack("<I", arr.size) + \
            arr.tobytes()
    raise ValueError(f"Unknown aux type: {typ}")


# thread-local scratch: encode_bamlet_record returns a memoryview into
# this buffer, so concurrent encoders must not share it
import threading as _threading
_ENC_TLS = _threading.local()


def encode_bamlet_record(qname: str, flag: int, ref_id: int, pos: int,
                         mapq: int, cigar: Optional[List[Tuple[int, str]]],
                         bases: bytes, quals: bytes, tr_id: str,
                         rq: float, meth, mismatch_offsets, hp,
                         so: int, eo: int, al: int,
                         flank_len: int):
    """Native (C++) encoder for the fixed BAMlet aux schema
    (TR/rq/[MC]/[MO]/[HP]/SO/EO/AL/FL, ref write_bam.rs:113-140);
    byte-identical to write_record with the equivalent aux list
    (tests/test_native.py). Returns the length-prefixed record bytes,
    or None when the native library is unavailable."""
    from . import native
    import ctypes
    lib = native.get_lib()
    if lib is None:
        return None
    cigar = cigar or []
    n_cigar = len(cigar)
    cig_arr = np.fromiter(((length << 4) | CIGAR_OP_CODE[op]
                           for length, op in cigar), dtype=np.uint32,
                          count=n_cigar)
    if meth is None:
        mc, mc_len = b"", -1
    elif isinstance(meth, (bytes, bytearray)):
        mc = bytes(meth)
        mc_len = len(mc)
    else:
        mc = np.asarray(meth, dtype=np.uint8).tobytes()
        mc_len = len(mc)
    if mismatch_offsets is not None:
        mo_b = np.asarray(mismatch_offsets, dtype=np.int32).tobytes()
        mo_len = len(mo_b) // 4
    else:
        mo_b, mo_len = b"", -1
    cap = (64 + len(qname) + len(tr_id) + 4 * n_cigar + 2 * len(bases)
           + mc_len + 8 * max(mo_len, 0) + 64)
    buf = getattr(_ENC_TLS, "buf", None)
    if buf is None or len(buf) < cap:
        buf = np.empty(max(cap, 1 << 16), dtype=np.uint8)
        _ENC_TLS.buf = buf
        _ENC_TLS.ptr = buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8))
        _ENC_TLS.view = memoryview(buf)
    n = lib.trgt_bamlet_record(
        qname.encode("ascii"), flag, ref_id, pos, mapq,
        cig_arr.tobytes(), n_cigar, bases, len(bases),
        quals if isinstance(quals, bytes) else bytes(quals),
        tr_id.encode("ascii"), float(rq),
        mc, mc_len, mo_b, mo_len,
        -1 if hp is None else int(hp),
        so, eo, al, flank_len, _ENC_TLS.ptr, len(buf))
    if n < 0:
        return None
    # a memoryview slice: BgzfWriter.write copies it into its bytearray
    # immediately, so reusing the scratch buffer on the next call is
    # safe and the extra tobytes() copy is avoided
    return _ENC_TLS.view[:n]


def build_record(qname: str, flag: int, ref_id: int, pos: int,
                 mapq: int, cigar, seq: str, qual: bytes,
                 aux) -> Tuple[bytes, int]:
    """Encode one length-prefixed BAM record (Python path, BAM spec
    §4.2); returns (record bytes, reference end) for BAI bookkeeping."""
    cigar = cigar or []
    qname_b = qname.encode("ascii") + b"\0"
    n_cigar = len(cigar)
    l_seq = len(seq)
    ref_len = sum(length for length, op in cigar if op in "MDN=X")
    if cigar:
        bin_v = reg2bin(pos, pos + max(1, ref_len))
    else:
        bin_v = reg2bin(pos, pos + 1)
    parts = [
        struct.pack("<iiBBHHHIiii", ref_id, pos, len(qname_b), mapq,
                    bin_v, n_cigar, flag, l_seq, -1, -1, 0),
        qname_b,
        struct.pack(f"<{n_cigar}I",
                    *((length << 4) | CIGAR_OP_CODE[op]
                      for length, op in cigar)),
        pack_seq(seq),
        bytes(qual),
    ]
    parts.extend(encode_aux(tag, typ, value) for tag, typ, value in aux)
    rec = b"".join(parts)
    return struct.pack("<i", len(rec)) + rec, pos + ref_len


class BaiBuilder:
    """Builds a .bai index for records written in sorted order
    (replaces `samtools index` for our own sorted outputs)."""

    def __init__(self, n_ref: int):
        self.bins = [dict() for _ in range(n_ref)]     # bin -> [chunks]
        self.linear = [dict() for _ in range(n_ref)]   # window -> min voff

    def add(self, ref_id: int, pos: int, ref_end: int, voff_start: int,
            voff_end: int) -> None:
        if ref_id < 0:
            return
        b = reg2bin(pos, max(ref_end, pos + 1))
        chunks = self.bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff_start, voff_end))
        for w in range(pos >> 14, (max(ref_end, pos + 1) - 1 >> 14) + 1):
            cur = self.linear[ref_id].get(w)
            if cur is None or voff_start < cur:
                self.linear[ref_id][w] = voff_start

    def write(self, path: str) -> None:
        out = [b"BAI\x01", struct.pack("<i", len(self.bins))]
        for bins, linear in zip(self.bins, self.linear):
            out.append(struct.pack("<i", len(bins)))
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out.append(struct.pack("<Ii", bin_id, len(chunks)))
                for beg, end in chunks:
                    out.append(struct.pack("<QQ", beg, end))
            n_intv = max(linear, default=-1) + 1
            out.append(struct.pack("<i", n_intv))
            filled = 0
            for w in range(n_intv):
                v = linear.get(w)
                if v is not None:
                    filled = v
                out.append(struct.pack("<Q", v if v is not None else filled))
        with open(path, "wb") as fh:
            fh.write(b"".join(out))


class BamWriter:
    # BGZF level 2: ~6x faster deflate than zlib's default 6 for ~1%
    # larger output (measured on BAM record bytes) — the BAMlet is an
    # auxiliary evidence file and its deflate was the writer thread's
    # dominant cost at the 10^4-locus scale (benchmarks/scale10k.py)
    def __init__(self, path: str, header_text: str,
                 references: List[Tuple[str, int]],
                 build_index: bool = False, level: int = 2):
        self._bgzf = BgzfWriter(path, level=level)
        self._path = path
        self._bai = BaiBuilder(len(references)) if build_index else None
        self.header = BamHeader(header_text, references)
        text = header_text.encode("utf-8")
        body = b"BAM\x01" + struct.pack("<i", len(text)) + text
        body += struct.pack("<i", len(references))
        for name, length in references:
            nb = name.encode("ascii") + b"\0"
            body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._bgzf.write(body)

    def write_record(self, qname: str, flag: int, ref_id: int, pos: int,
                     mapq: int, cigar: Optional[List[Tuple[int, str]]],
                     seq: str, qual: bytes,
                     aux: List[Tuple[str, str, object]]):
        rec, ref_end = build_record(qname, flag, ref_id, pos, mapq,
                                    cigar, seq, qual, aux)
        self.write_encoded(rec, ref_id, pos, ref_end)

    def write_encoded(self, rec_with_len: bytes, ref_id: int, pos: int,
                      ref_end: int):
        """Write a pre-encoded (length-prefixed) record — the native
        encoder fast path — keeping BAI bookkeeping identical."""
        voff_start = self._bgzf.tell_virtual()
        self._bgzf.write(rec_with_len)
        if self._bai is not None:
            self._bai.add(ref_id, pos, ref_end, voff_start,
                          self._bgzf.tell_virtual())

    def close(self):
        self._bgzf.close()
        if self._bai is not None:
            self._bai.write(self._path + ".bai")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
