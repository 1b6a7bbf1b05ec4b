"""CRAM 3.0 writer.

Produces spec-conformant CRAM: one slice per container, all data series
in EXTERNAL blocks (gzip-compressed), absolute alignment positions,
read names preserved, reference-based feature encoding (X substitutions
via the substitution matrix, I/D/S/N/P/H features, 'B' fallback for
non-ACGTN mismatches), per-slice reference MD5, .crai index, and the
standard EOF container. Primary consumer is io/cram.py's CramReader
(round-trip tested); files follow the public spec so external tools can
read them too.

Also hosts the rANS4x8 encoder (orders 0 and 1) used to exercise the
reader's rANS decoder.
"""

import gzip
import hashlib
import struct
import zlib
from typing import Dict, List, Optional, Tuple

from .bam import BamHeader
from .cram import CRAM_MAGIC, RANS_L, TOTFREQ

# The fixed 38-byte CRAM 3.0 EOF container (spec section 9.4.2).
EOF_CONTAINER = bytes.fromhex(
    "0f000000ffffffff0fe045" "4f4600000000010005bdd94f"
    "00010006060100010001" "00ee63014b")


def itf8(value: int) -> bytes:
    v = value & 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def ltf8(value: int) -> bytes:
    v = value & 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    out = []
    n = v.bit_length()
    n_bytes = (n + 7) // 8          # payload bytes needed
    # prefix byte holds (7 - n_extra) value bits; find smallest fit
    for n_extra in range(1, 9):
        prefix_capacity = 7 - n_extra if n_extra < 8 else 0
        if n <= 8 * n_extra + prefix_capacity:
            break
    prefix = (0xFF << (8 - n_extra)) & 0xFF
    if n_extra < 8:
        prefix |= (v >> (8 * n_extra)) & ((1 << (7 - n_extra)) - 1)
    out.append(prefix)
    for i in range(n_extra - 1, -1, -1):
        out.append((v >> (8 * i)) & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------- rANS 4x8

def _normalize_freqs(counts: Dict[int, int]) -> Dict[int, int]:
    total = sum(counts.values())
    if total == 0:
        return {}
    freqs = {}
    acc = 0
    items = sorted(counts.items())
    for i, (sym, c) in enumerate(items):
        if i == len(items) - 1:
            f = TOTFREQ - acc
        else:
            f = max(1, c * TOTFREQ // total)
            f = min(f, TOTFREQ - acc - (len(items) - 1 - i))
        freqs[sym] = f
        acc += f
    assert acc == TOTFREQ, acc
    return freqs


def _write_freq(f: int) -> bytes:
    if f < 0x80:
        return bytes([f])
    return bytes([0x80 | (f >> 8), f & 0xFF])


def _encode_table0(freqs: Dict[int, int]) -> bytes:
    """Order-0 frequency table serialization (RLE over ascending syms)."""
    syms = sorted(freqs)
    out = bytearray()
    i = 0
    n = len(syms)
    while i < n:
        run = 0
        while i + run + 1 < n and syms[i + run + 1] == syms[i + run] + 1:
            run += 1
        out.append(syms[i])
        out += _write_freq(freqs[syms[i]])
        if run > 0:
            out.append(syms[i] + 1)       # signals an RLE run
            out.append(run - 1)           # symbols after syms[i]+1
            for k in range(1, run + 1):
                out += _write_freq(freqs[syms[i] + k])
        i += 1 + run
    out.append(0)
    return bytes(out)


def rans_encode(data: bytes, order: int = 0) -> bytes:
    """rANS4x8 encode (CRAM spec section 13)."""
    out_size = len(data)
    if order == 0:
        counts: Dict[int, int] = {}
        for b in data:
            counts[b] = counts.get(b, 0) + 1
        if not counts:
            counts = {0: 1}
        freqs = _normalize_freqs(counts)
        cum = {}
        c = 0
        for s in sorted(freqs):
            cum[s] = c
            c += freqs[s]
        table = _encode_table0(freqs)
        states = [RANS_L] * 4
        emitted = bytearray()
        for i in range(out_size - 1, -1, -1):
            j = i & 3
            s = data[i]
            x = states[j]
            f = freqs[s]
            x_max = ((RANS_L >> 12) << 8) * f
            while x >= x_max:
                emitted.append(x & 0xFF)
                x >>= 8
            states[j] = ((x // f) << 12) + (x % f) + cum[s]
        stream = struct.pack("<4I", *states) + bytes(reversed(emitted))
        body = table + stream
        return bytes([0]) + struct.pack("<ii", len(body), out_size) + body

    assert order == 1
    isz4 = out_size >> 2
    segs = [data[0:isz4], data[isz4:2 * isz4], data[2 * isz4:3 * isz4],
            data[3 * isz4:]]
    counts: Dict[int, Dict[int, int]] = {}
    for seg in segs:
        prev = 0
        for b in seg:
            counts.setdefault(prev, {})[b] = \
                counts.setdefault(prev, {}).get(b, 0) + 1
            prev = b
    if not counts:
        counts = {0: {0: 1}}
    freqs = {c: _normalize_freqs(f) for c, f in counts.items()}
    cums = {}
    for c, f in freqs.items():
        cum = {}
        acc = 0
        for s in sorted(f):
            cum[s] = acc
            acc += f[s]
        cums[c] = cum
    # table: symbol-RLE over contexts, each followed by an order-0 table
    ctxs = sorted(freqs)
    table = bytearray()
    i = 0
    n = len(ctxs)
    while i < n:
        run = 0
        while i + run + 1 < n and ctxs[i + run + 1] == ctxs[i + run] + 1:
            run += 1
        table.append(ctxs[i])
        table += _encode_table0(freqs[ctxs[i]])
        if run > 0:
            table.append(ctxs[i] + 1)
            table.append(run - 1)
            for k in range(1, run + 1):
                table += _encode_table0(freqs[ctxs[i] + k])
        i += 1 + run
    table.append(0)

    # encode in exact reverse of the decode order: remainder (state 3)
    # first, then interleaved (i, j) backwards
    states = [RANS_L] * 4
    emitted = bytearray()

    def enc(j, sym, ctx):
        f = freqs[ctx][sym]
        cum = cums[ctx][sym]
        x = states[j]
        x_max = ((RANS_L >> 12) << 8) * f
        while x >= x_max:
            emitted.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << 12) + (x % f) + cum

    seg3 = segs[3]
    for i in range(out_size - 1, 4 * isz4 - 1, -1):
        pos_in_seg = i - 3 * isz4
        ctx = seg3[pos_in_seg - 1] if pos_in_seg > 0 else 0
        enc(3, data[i], ctx)
    for i in range(isz4 - 1, -1, -1):
        for j in (3, 2, 1, 0):
            sym = segs[j][i]
            ctx = segs[j][i - 1] if i > 0 else 0
            enc(j, sym, ctx)
    stream = struct.pack("<4I", *states) + bytes(reversed(emitted))
    body = bytes(table) + stream
    return bytes([1]) + struct.pack("<ii", len(body), out_size) + body


# ------------------------------------------------------------------ writer

# data series and their dedicated external block content ids
_SERIES = ["BF", "CF", "RL", "AP", "RG", "RN", "TL", "FN", "FC", "FP",
           "BS", "DL", "RS", "PD", "HC", "MQ", "QS", "BA", "IN", "SC"]
_CID = {key: i + 1 for i, key in enumerate(_SERIES)}
_TAG_CID_BASE = 100

_BASES = b"ACGTN"
# identity-ranked substitution matrix: for every reference base the alt
# bases (ACGTN order) get codes 0..3 → each row byte is 0b00011011
_SM = bytes([0x1B] * 5)
_SUB_CODE = {}
for _r in _BASES:
    alts = [b for b in _BASES if b != _r]
    for _code, _alt in enumerate(alts):
        _SUB_CODE[(_r, _alt)] = _code


def _encoding_external(cid: int) -> bytes:
    params = itf8(cid)
    return itf8(1) + itf8(len(params)) + params


def _encoding_byte_array_len_ext(cid: int) -> bytes:
    """BYTE_ARRAY_LEN with both the length and values EXTERNAL in the
    same block (decoder reads ITF8 length then bytes sequentially)."""
    nested_len = _encoding_external(cid)
    nested_val = _encoding_external(cid)
    params = nested_len + nested_val
    return itf8(4) + itf8(len(params)) + params


def _encoding_byte_array_stop(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + itf8(cid)
    return itf8(5) + itf8(len(params)) + params


def _block(method: int, content_type: int, content_id: int,
           data: bytes) -> bytes:
    if method == 1:
        payload = gzip.compress(data, 4)
    else:
        payload = data
    out = bytes([method, content_type]) + itf8(content_id) + \
        itf8(len(payload)) + itf8(len(data)) + payload
    return out + struct.pack("<I", zlib.crc32(out) & 0xFFFFFFFF)


class _Rec:
    __slots__ = ("qname", "flag", "ref_id", "pos", "mapq", "cigar",
                 "seq", "qual", "aux")

    def __init__(self, qname, flag, ref_id, pos, mapq, cigar, seq, qual,
                 aux):
        self.qname = qname
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos
        self.mapq = mapq
        self.cigar = cigar or []
        self.seq = seq
        self.qual = qual
        self.aux = aux


def _aux_payload(typ: str, value) -> bytes:
    from .bam_write import encode_aux
    return encode_aux("..", typ, value)[3:]


class CramWriter:
    """Same write_record surface as io.bam_write.BamWriter."""

    RECORDS_PER_SLICE = 1000

    def __init__(self, path: str, header_text: str,
                 references: List[Tuple[str, int]],
                 reference_path: Optional[str] = None,
                 build_index: bool = True):
        self.path = path
        self._fh = open(path, "wb")
        self.header = BamHeader(header_text, references)
        self._reference_path = reference_path
        self._fasta = None
        self._ref_cache: Dict[int, bytes] = {}
        self._pending: List[_Rec] = []
        self._crai: List[Tuple[int, int, int, int, int, int]] = []
        self._build_index = build_index
        self._counter = 0
        file_id = (path.encode("utf-8")[-20:]).ljust(20, b"\0")
        self._fh.write(CRAM_MAGIC + bytes([3, 0]) + file_id)
        # SAM header container
        text = header_text.encode("utf-8")
        hdata = struct.pack("<i", len(text)) + text
        blk = _block(0, 0, 0, hdata)
        self._write_container(-1, 0, 0, 0, [blk], n_blocks=1,
                              landmarks=[])

    def _write_container(self, ref_id, start, span, n_records, blocks,
                         n_blocks, landmarks):
        body = b"".join(blocks)
        head = itf8(ref_id) + itf8(start) + itf8(span) + \
            itf8(n_records) + ltf8(self._counter) + ltf8(0) + \
            itf8(n_blocks) + itf8(len(landmarks)) + \
            b"".join(itf8(v) for v in landmarks)
        head += struct.pack("<I", zlib.crc32(head) & 0xFFFFFFFF)
        offset = self._fh.tell()
        self._fh.write(struct.pack("<i", len(body)) + head + body)
        return offset

    def _ref_seq(self, ref_id: int) -> bytes:
        cached = self._ref_cache.get(ref_id)
        if cached is not None:
            return cached
        if self._reference_path is None:
            raise IOError("CRAM writing requires a reference FASTA")
        if self._fasta is None:
            from .fasta import FastaReader
            self._fasta = FastaReader(self._reference_path)
        name, length = self.header.references[ref_id]
        seq = self._fasta.fetch(name, 0, length).upper().encode("ascii")
        if len(self._ref_cache) > 4:
            self._ref_cache.clear()
        self._ref_cache[ref_id] = seq
        return seq

    def write_record(self, qname, flag, ref_id, pos, mapq, cigar, seq,
                     qual, aux):
        rec = _Rec(qname, flag, ref_id, pos, mapq, cigar, seq,
                   bytes(qual), list(aux))
        if self._pending and (self._pending[0].ref_id != rec.ref_id or
                              len(self._pending) >=
                              self.RECORDS_PER_SLICE):
            self._flush()
        self._pending.append(rec)

    def _flush(self):
        if not self._pending:
            return
        recs = self._pending
        self._pending = []
        ref_id = recs[0].ref_id
        mapped = [r for r in recs if not (r.flag & 0x4)]
        if mapped:
            start = min(r.pos for r in mapped) + 1
            end = max(r.pos + sum(l for l, op in r.cigar
                                  if op in "MDN=X") for r in mapped)
            span = end - (start - 1)
        else:
            start, span = 0, 0

        # tag dictionary
        tag_lines: List[Tuple[Tuple[str, str], ...]] = []
        line_of = {}
        rec_tl = []
        for r in recs:
            line = tuple((t, typ) for t, typ, _v in r.aux)
            if line not in line_of:
                line_of[line] = len(tag_lines)
                tag_lines.append(line)
            rec_tl.append(line_of[line])
        tag_keys = sorted({kt for line in tag_lines for kt in line})
        tag_cid = {kt: _TAG_CID_BASE + i for i, kt in enumerate(tag_keys)}

        ext: Dict[int, bytearray] = {cid: bytearray()
                                     for cid in _CID.values()}
        for cid in tag_cid.values():
            ext[cid] = bytearray()

        def put_int(key, v):
            ext[_CID[key]] += itf8(v)

        ref = self._ref_seq(ref_id) if mapped else b""
        for r, tl in zip(recs, rec_tl):
            seq_b = r.seq.encode("ascii").upper()
            put_int("BF", r.flag)
            put_int("CF", 1)               # quality scores stored
            put_int("RL", len(seq_b))
            put_int("AP", r.pos + 1)
            put_int("RG", -1)
            ext[_CID["RN"]] += r.qname.encode("ascii") + b"\0"
            put_int("TL", tl)
            for tag, typ, value in r.aux:
                payload = _aux_payload(typ, value)
                ext[tag_cid[(tag, typ)]] += itf8(len(payload)) + payload
            if r.flag & 0x4:
                ext[_CID["BA"]] += seq_b
                ext[_CID["QS"]] += r.qual
                continue
            self._encode_features(r, seq_b, ref, ext)
            put_int("MQ", r.mapq)
            ext[_CID["QS"]] += r.qual

        # inside _encode_features we already wrote FN/FC/FP/...; build
        # compression header
        pres = bytearray()
        entries = []
        entries.append(b"RN" + bytes([1]))
        entries.append(b"AP" + bytes([0]))
        entries.append(b"RR" + bytes([1]))
        entries.append(b"SM" + _SM)
        td_blob = bytearray()
        for line in tag_lines:
            for tag, typ in line:
                td_blob += tag.encode("ascii") + typ.encode("ascii")
            td_blob.append(0)
        entries.append(b"TD" + itf8(len(td_blob)) + bytes(td_blob))
        pres_body = itf8(len(entries)) + b"".join(entries)
        pres = itf8(len(pres_body)) + pres_body

        ds_entries = []
        for key in _SERIES:
            if key == "RN":
                enc = _encoding_byte_array_stop(0, _CID["RN"])
            elif key in ("IN", "SC"):
                enc = _encoding_byte_array_len_ext(_CID[key])
            else:
                enc = _encoding_external(_CID[key])
            ds_entries.append(key.encode("ascii") + enc)
        ds_body = itf8(len(ds_entries)) + b"".join(ds_entries)
        ds = itf8(len(ds_body)) + ds_body

        tag_entries = []
        for (tag, typ), cid in tag_cid.items():
            key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
            tag_entries.append(itf8(key) +
                               _encoding_byte_array_len_ext(cid))
        tag_body = itf8(len(tag_entries)) + b"".join(tag_entries)
        tags_map = itf8(len(tag_body)) + tag_body

        comp_data = bytes(pres) + bytes(ds) + bytes(tags_map)
        comp_block = _block(1, 1, 0, comp_data)

        used_cids = [cid for cid, buf in sorted(ext.items()) if buf]
        md5 = hashlib.md5(
            ref[start - 1:start - 1 + span] if mapped else b"").digest()
        slice_data = itf8(ref_id) + itf8(start) + itf8(span) + \
            itf8(len(recs)) + ltf8(self._counter) + \
            itf8(1 + len(used_cids)) + itf8(len(used_cids)) + \
            b"".join(itf8(c) for c in used_cids) + itf8(-1) + md5
        slice_block = _block(0, 2, 0, slice_data)
        core_block = _block(0, 5, 0, b"")
        ext_blocks = [_block(1, 4, cid, bytes(ext[cid]))
                      for cid in used_cids]

        blocks = [comp_block, slice_block, core_block] + ext_blocks
        landmark = len(comp_block)
        slice_size = len(slice_block) + len(core_block) + \
            sum(len(b) for b in ext_blocks)
        offset = self._write_container(
            ref_id, start, span, len(recs), blocks,
            n_blocks=len(blocks), landmarks=[landmark])
        self._crai.append((ref_id, start, span, offset, landmark,
                           slice_size))
        self._counter += len(recs)

    def _encode_features(self, r: _Rec, seq_b: bytes, ref: bytes,
                         ext: Dict[int, bytearray]):
        features = []         # (read_pos_1based, code, payload)
        seq_pos = 0
        ref_pos = r.pos
        for length, op in r.cigar:
            if op in "M=X":
                for k in range(length):
                    rb = ref[ref_pos + k] if ref_pos + k < len(ref) \
                        else ord("N")
                    qb = seq_b[seq_pos + k]
                    if qb != rb:
                        code = _SUB_CODE.get((rb if rb in _BASES
                                              else ord("N"), qb))
                        if code is not None:
                            features.append((seq_pos + k + 1, "X", code))
                        else:
                            features.append((seq_pos + k + 1, "B",
                                             (qb, r.qual[seq_pos + k])))
                seq_pos += length
                ref_pos += length
            elif op == "I":
                features.append((seq_pos + 1, "I",
                                 seq_b[seq_pos:seq_pos + length]))
                seq_pos += length
            elif op == "S":
                features.append((seq_pos + 1, "S",
                                 seq_b[seq_pos:seq_pos + length]))
                seq_pos += length
            elif op == "D":
                features.append((seq_pos + 1, "D", length))
                ref_pos += length
            elif op == "N":
                features.append((seq_pos + 1, "N", length))
                ref_pos += length
            elif op == "P":
                features.append((seq_pos + 1, "P", length))
            elif op == "H":
                features.append((seq_pos + 1, "H", length))
            else:
                raise ValueError(f"Unsupported CIGAR op {op!r} for CRAM")

        ext[_CID["FN"]] += itf8(len(features))
        prev = 0
        for pos1, code, payload in features:
            ext[_CID["FC"]].append(ord(code))
            ext[_CID["FP"]] += itf8(pos1 - prev)
            prev = pos1
            if code == "X":
                ext[_CID["BS"]].append(payload)
            elif code in ("I", "S"):
                key = "IN" if code == "I" else "SC"
                ext[_CID[key]] += itf8(len(payload)) + payload
            elif code == "D":
                ext[_CID["DL"]] += itf8(payload)
            elif code == "N":
                ext[_CID["RS"]] += itf8(payload)
            elif code == "P":
                ext[_CID["PD"]] += itf8(payload)
            elif code == "H":
                ext[_CID["HC"]] += itf8(payload)
            elif code == "B":
                qb, qv = payload
                ext[_CID["BA"]].append(qb)
                ext[_CID["QS"]].append(qv)

    def close(self):
        self._flush()
        self._fh.write(EOF_CONTAINER)
        self._fh.close()
        if self._build_index:
            with gzip.open(self.path + ".crai", "wt") as fh:
                for entry in self._crai:
                    fh.write("\t".join(str(x) for x in entry) + "\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
