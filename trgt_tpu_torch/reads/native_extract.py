"""Native batched read extraction (C++ fast path).

Drives csrc/bamcodec.cpp `trgt_extract_reads`: per BAI chunk, the
compressed slice is read once, inflated natively, and every record is
filtered, decoded (seq/quals/cigar/aux), MM/ML-meth-projected,
SNP-offset-scanned and region-clipped in one C++ pass — the fused
equivalent of workflow.extract_reads + clip_reads (reference logic at
src/trgt/workflows/tr.rs:268-361 + src/trgt/reads/clip_region.rs:19-190).
The Python implementations remain the behavioural twin; a test asserts
equality on real and synthetic BAMs.
"""

import ctypes
import logging
import struct
from typing import List, Optional

from ..io import native as _native
from ..utils import GenomicRegion
from .hifi_read import Cigar, HiFiRead

log = logging.getLogger("trgt")

_CIGAR_OPS = "MIDNSHP=X"
_configured = False


def _get_lib():
    global _configured
    lib = _native.get_lib()
    if lib is None:
        return None
    if not _configured:
        lib.trgt_bgzf_decompress_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.trgt_bgzf_decompress_chunk.restype = ctypes.c_int
        lib.trgt_extract_reads.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.trgt_extract_reads.restype = ctypes.c_int
        _configured = True
    return lib


def native_extract_available(bam) -> bool:
    # BAM only (BGZF+BAI); CRAM input uses the Python extraction twin
    return (_get_lib() is not None
            and hasattr(bam, "_bgzf")
            and hasattr(bam, "_load_index")
            and isinstance(getattr(bam, "path", None), str))


def extract_and_clip_native(locus, bam, params,
                            clip_radius: int) -> Optional[List[HiFiRead]]:
    """Fused extract+clip; returns None when the native path is
    unavailable or errors (callers fall back to the Python twin)."""
    lib = _get_lib()
    if lib is None:
        return None
    region = locus.region
    tid = bam.header.tid(region.contig)
    if tid is None:
        return []
    try:
        index = bam._load_index()
    except IOError:
        return None
    flank_len = params.search_flank_len
    beg = max(0, region.start - flank_len)
    end = region.end + flank_len
    chunks = index.chunks_for(tid, beg, end)

    blobs: List[bytes] = []
    n_pass = 0
    n_filt = 0
    for vbeg, vend in chunks:
        cbeg, ubeg = vbeg >> 16, vbeg & 0xFFFF
        cend, uend = vend >> 16, vend & 0xFFFF
        cached = _chunk_buffer(bam, lib, cbeg, cend, uend)
        if cached is None:
            return None
        buf, walk_end = cached
        blob_p = ctypes.POINTER(ctypes.c_uint8)()
        blob_size = ctypes.c_size_t()
        c_pass = ctypes.c_int64()
        c_filt = ctypes.c_int64()
        rc = lib.trgt_extract_reads(
            buf, len(buf), ubeg, walk_end,
            tid, beg, end,
            region.start, region.end,
            region.start - clip_radius, region.end + clip_radius,
            float(params.min_read_qual),
            ctypes.byref(blob_p), ctypes.byref(blob_size),
            ctypes.byref(c_pass), ctypes.byref(c_filt))
        if rc != 0:
            return None
        try:
            blobs.append(ctypes.string_at(blob_p, blob_size.value))
        finally:
            lib.trgt_buf_free(blob_p)
        n_pass += c_pass.value
        n_filt += c_filt.value

    if n_filt > 0:
        log.warning("%s: Quality filtered %d/%d reads", locus.id, n_filt,
                    n_filt + n_pass)

    blob = b"".join(blobs)
    keep = None
    reservoir_threshold = params.max_depth * 3
    if n_pass > reservoir_threshold:
        # replay the reservoir index walk (workflow.StdRngReservoir)
        from ..engine.workflow import StdRngReservoir
        log.warning("%s: Reservoir sampling reads", locus.id)
        rng = StdRngReservoir(42)
        kept_idx = list(range(reservoir_threshold))
        for i in range(reservoir_threshold, n_pass):
            j = rng.range(i)
            if j < reservoir_threshold:
                kept_idx[j] = i
        keep = kept_idx

    return _deserialize(blob, region, keep)


def _chunk_buffer(bam, lib, cbeg: int, cend: int, uend: int):
    """Decompressed BAI-chunk buffer with a small per-reader LRU cache
    (neighbouring loci usually share chunks)."""
    cache = getattr(bam, "_native_chunk_cache", None)
    if cache is None:
        cache = {}
        bam._native_chunk_cache = cache
    key = (cbeg, cend, uend)
    hit = cache.pop(key, None)
    if hit is not None:
        cache[key] = hit            # refresh LRU position
        return hit
    fh = getattr(bam, "_native_fh", None)
    if fh is None:
        fh = open(bam.path, "rb")
        bam._native_fh = fh
    fh.seek(cbeg)
    comp = fh.read(cend - cbeg + 65536)
    buf_p = ctypes.POINTER(ctypes.c_uint8)()
    buf_size = ctypes.c_size_t()
    walk_end = ctypes.c_size_t()
    rc = lib.trgt_bgzf_decompress_chunk(
        comp, len(comp), cend - cbeg, uend,
        ctypes.byref(buf_p), ctypes.byref(buf_size),
        ctypes.byref(walk_end))
    if rc != 0:
        return None
    try:
        entry = (ctypes.string_at(buf_p, buf_size.value), walk_end.value)
    finally:
        lib.trgt_buf_free(buf_p)
    while len(cache) >= 4:
        cache.pop(next(iter(cache)))
    cache[key] = entry
    return entry


def _deserialize(blob: bytes, region: GenomicRegion,
                 keep: Optional[List[int]]) -> List[HiFiRead]:
    records: List[HiFiRead] = []
    want = None if keep is None else set(keep)
    pos = 0
    n = len(blob)
    idx = 0
    by_index = {}
    while pos < n:
        parse = want is None or idx in want
        (qlen,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        qname = blob[pos:pos + qlen]
        pos += qlen
        flag, mapq, has_rq, rq, hp, ref_pos, start_off, end_off, nb = \
            struct.unpack_from("<HBBfiqiiI", blob, pos)
        pos += 32
        bases = blob[pos:pos + nb]
        pos += nb
        quals = blob[pos:pos + nb]
        pos += nb
        (n_meth,) = struct.unpack_from("<i", blob, pos)
        pos += 4
        meth = None
        if n_meth >= 0:
            meth = blob[pos:pos + n_meth]
            pos += n_meth
        (n_ops,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        ops_raw = struct.unpack_from(f"<{n_ops}I", blob, pos)
        pos += 4 * n_ops
        (n_mism,) = struct.unpack_from("<i", blob, pos)
        pos += 4
        mism = None
        if n_mism >= 0:
            mism = list(struct.unpack_from(f"<{n_mism}i", blob, pos))
            pos += 4 * n_mism
        if parse:
            read = HiFiRead(
                id=qname.decode("ascii"),
                is_reverse=bool(flag & 0x10),
                bases=bases,
                quals=quals,
                meth=meth,
                read_qual=rq if has_rq else None,
                mismatch_offsets=mism,
                start_offset=start_off,
                end_offset=end_off,
                cigar=Cigar(ref_pos=ref_pos,
                            ops=[(v >> 4, _CIGAR_OPS[v & 0xF])
                                 for v in ops_raw]),
                hp_tag=None if hp == -(1 << 31) else hp,
                mapq=mapq,
            )
            if want is None:
                records.append(read)
            else:
                by_index[idx] = read
        idx += 1
    if keep is not None:
        # the reservoir's ARRAY order (reads[j] = replacement), not
        # sorted index order — matches the Python twin exactly
        return [by_index[i] for i in keep]
    return records
