"""Input files of the benchmark, written without the program's own
writers: FASTA (+ .fai), BED, and a coordinate-sorted BAM with its BAI
index (SAM/BAM format specification, sections 4.1-4.2 and 5.2). Also a
reader of single BAM records, for the spanning reads the program writes.

Frozen with the benchmark, so that a change to the program's BAM writer
cannot change what the program is given to read.
"""

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BGZF_BLOCK = 65280
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b00"
                         "03000000000000000000")
CIGAR_CODE = {op: i for i, op in enumerate("MIDNSHP=X")}
SEQ_NT16 = "=ACMGRSVTWYHKDBN"

_NT16 = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(SEQ_NT16):
    _NT16[ord(_c)] = _i


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


def write_fasta(path: str, contig: str, seq: np.ndarray) -> None:
    """`seq` as ASCII codes; 60 bases a line, with its .fai."""
    n = len(seq)
    full = n // 60
    body = np.full((full, 61), ord("\n"), dtype=np.uint8)
    body[:, :60] = seq[:full * 60].reshape(full, 60)
    tail = seq[full * 60:].tobytes()
    with open(path, "wb") as fh:
        fh.write(f">{contig}\n".encode())
        fh.write(body.tobytes())
        if tail:
            fh.write(tail + b"\n")
    with open(path + ".fai", "w") as fh:
        fh.write(f"{contig}\t{n}\t{len(contig) + 2}\t60\t61\n")


def encode_record(name: str, pos: int, cigar, seq: np.ndarray,
                  qual: int, rq: float) -> bytes:
    """One length-prefixed BAM record: forward strand, mapq 60, constant
    base quality `qual`, an `rq` tag."""
    qname = name.encode() + b"\0"
    ref_len = sum(n for n, op in cigar if op in "MDN=X")
    cig = struct.pack(f"<{len(cigar)}I",
                      *((n << 4) | CIGAR_CODE[op] for n, op in cigar))
    codes = _NT16[seq]
    if len(codes) % 2:
        codes = np.append(codes, np.uint8(0))
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    core = struct.pack("<iiBBHHHIiii", 0, pos, len(qname), 60,
                       reg2bin(pos, pos + max(1, ref_len)), len(cigar), 0,
                       len(seq), -1, -1, 0)
    body = (core + qname + cig + packed + bytes([qual]) * len(seq)
            + b"rqf" + struct.pack("<f", rq))
    return struct.pack("<i", len(body)) + body


def _deflate(chunk: bytes) -> bytes:
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    header = struct.pack("<4BI2BH2BHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                         66, 67, 2, len(cdata) + 25)
    return (header + cdata
            + struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk)))


def write_bam(path: str, contig: str, contig_len: int, records) -> None:
    """`records`: (pos, ref_end, length-prefixed bytes), sorted by pos.
    Writes the BAM and `path`.bai."""
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{contig_len}\n"
            f"@RG\tID:rg1\tSM:sample\n").encode()
    name = contig.encode() + b"\0"
    head = (b"BAM\x01" + struct.pack("<i", len(text)) + text
            + struct.pack("<ii", 1, len(name)) + name
            + struct.pack("<i", contig_len))
    starts = np.empty(len(records) + 1, dtype=np.int64)
    offset = len(head)
    for k, (_, _, rec) in enumerate(records):
        starts[k] = offset
        offset += len(rec)
    starts[-1] = offset
    data = b"".join([head] + [rec for _, _, rec in records])
    chunks = [data[i:i + BGZF_BLOCK] for i in range(0, len(data), BGZF_BLOCK)]
    with ThreadPoolExecutor(4) as pool:
        blocks = list(pool.map(_deflate, chunks))
    coffset = np.zeros(len(blocks) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blocks], out=coffset[1:])
    with open(path, "wb") as fh:
        for b in blocks:
            fh.write(b)
        fh.write(BGZF_EOF)
    block = starts // BGZF_BLOCK
    voff = (coffset[block] << 16) | (starts - block * BGZF_BLOCK)
    _write_bai(path + ".bai", records, voff)


def _write_bai(path: str, records, voff: np.ndarray) -> None:
    bins: dict = {}
    linear: dict = {}
    for k, (pos, end, _) in enumerate(records):
        b = reg2bin(pos, max(end, pos + 1))
        chunks = bins.setdefault(b, [])
        if chunks and chunks[-1][1] == voff[k]:
            chunks[-1][1] = int(voff[k + 1])
        else:
            chunks.append([int(voff[k]), int(voff[k + 1])])
        for w in range(pos >> 14, ((max(end, pos + 1) - 1) >> 14) + 1):
            if w not in linear or voff[k] < linear[w]:
                linear[w] = int(voff[k])
    out = [b"BAI\x01", struct.pack("<ii", 1, len(bins))]
    for b in sorted(bins):
        out.append(struct.pack("<Ii", b, len(bins[b])))
        out.extend(struct.pack("<QQ", c0, c1) for c0, c1 in bins[b])
    n_intv = max(linear, default=-1) + 1
    out.append(struct.pack("<i", n_intv))
    filled = 0
    for w in range(n_intv):
        filled = linear.get(w, filled)
        out.append(struct.pack("<Q", filled))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def parse_record(rec: bytes):
    """(read name, bases) of one length-prefixed BAM record."""
    body = memoryview(rec)[4:]
    l_name = body[8]
    n_cigar, _flag, l_seq = struct.unpack_from("<HHI", body, 12)
    name = bytes(body[32:32 + l_name - 1]).decode()
    s = 32 + l_name + 4 * n_cigar
    packed = np.frombuffer(body[s:s + (l_seq + 1) // 2], dtype=np.uint8)
    codes = np.empty(2 * len(packed), dtype=np.uint8)
    codes[0::2] = packed >> 4
    codes[1::2] = packed & 15
    table = np.frombuffer(SEQ_NT16.encode(), dtype=np.uint8)
    return name, table[codes[:l_seq]].tobytes()
