"""Native batched read extraction (C++ fast path).

Drives csrc/bamcodec.cpp `trgt_reader_extract`: one call a locus walks
the BAM from each BAI chunk's begin (clipped to the linear index's
floor) through the reader's cache of inflated BGZF blocks, inflating a
block only when the walk reaches it and none past the window, and
filters, decodes (seq/quals/cigar/aux), MM/ML-meth-projects,
SNP-offset-scans and region-clips every record it gathered in the same
call: the fused equivalent of workflow.extract_reads + clip_reads
(reference logic at src/trgt/workflows/tr.rs:268-361 +
src/trgt/reads/clip_region.rs:19-190). The Python implementations remain
the behavioural twin; a test asserts equality on real and synthetic BAMs.
"""

import ctypes
import logging
import struct
import time
from typing import List, Optional

from ..io import native as _native
from ..utils import GenomicRegion
from ..utils.recorder import add_time, count, timed
from .hifi_read import Cigar, HiFiRead

log = logging.getLogger("trgt")

_CIGAR_OPS = "MIDNSHP=X"
# inflated bytes a reader's block cache holds (some 250 blocks). On 30x
# HiFi WGS the blocks a worker inflates a locus stop falling at 8 MiB,
# far below the 145 MB a worker walks in one pass of a genome-wide
# catalog, so the cache holds the neighbourhood of the loci, not the BAM
BLOCK_CACHE_BYTES = 16 << 20
_configured = False


def _get_lib():
    global _configured
    lib = _native.get_lib()
    if lib is None:
        return None
    if not _configured:
        lib.trgt_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.trgt_reader_open.restype = ctypes.c_void_p
        lib.trgt_reader_close.argtypes = [ctypes.c_void_p]
        lib.trgt_reader_close.restype = None
        lib.trgt_reader_extract.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_size_t,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.trgt_reader_extract.restype = ctypes.c_int
        _configured = True
    return lib


class BlockReader:
    """The native reader of one BAM file: its descriptor and its cache
    of inflated BGZF blocks, up to `cache_bytes` (at least the block in
    use). The native side serialises its callers."""

    def __init__(self, path: str, cache_bytes: int = BLOCK_CACHE_BYTES):
        self._lib = _get_lib()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.trgt_reader_open(path.encode(),
                                                      cache_bytes)
        if not self._handle:
            raise IOError(f"cannot open {path} for the native walk")

    def close(self):
        if self._handle:
            self._lib.trgt_reader_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def extract(self, chunks, tid: int, beg: int, end: int, region,
                clip_radius: int, min_rq: float):
        """(blob, n_pass, n_filt) of the walk over `chunks`, or None on
        a malformed file. Counts the blocks and times their inflation."""
        flat = (ctypes.c_uint64 * (2 * len(chunks)))(
            *(v for chunk in chunks for v in chunk))
        blob_p = ctypes.POINTER(ctypes.c_uint8)()
        blob_size = ctypes.c_size_t()
        c_pass = ctypes.c_int64()
        c_filt = ctypes.c_int64()
        stats = (ctypes.c_int64 * 4)()
        t0 = time.perf_counter()
        rc = self._lib.trgt_reader_extract(
            self._handle, flat, len(chunks), tid, beg, end,
            region.start, region.end,
            region.start - clip_radius, region.end + clip_radius,
            float(min_rq), ctypes.byref(blob_p), ctypes.byref(blob_size),
            ctypes.byref(c_pass), ctypes.byref(c_filt), stats)
        if rc != 0:
            return None
        try:
            blob = ctypes.string_at(blob_p, blob_size.value)
        finally:
            self._lib.trgt_buf_free(blob_p)
        t1 = time.perf_counter()
        # reading and inflating interleave with the walk inside the one
        # call: its parts go on the timeline end to end, inflate first
        inflate_s = min(stats[3] * 1e-9, t1 - t0)
        add_time("extract.inflate", inflate_s, start=t0)
        add_time("extract.decode", t1 - (t0 + inflate_s),
                 start=t0 + inflate_s)
        count("extract_blocks_inflated", stats[0])
        count("extract_blocks_cached", stats[1])
        count("extract_inflated_bytes", stats[2])
        return blob, c_pass.value, c_filt.value


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
    if _get_lib() is None:
        return None
    region = locus.region
    tid = bam.header.tid(region.contig)
    if tid is None:
        return []
    try:
        index = bam._load_index()
        if bam.block_reader is None:
            bam.block_reader = BlockReader(bam.path)
    except IOError:
        return None
    flank_len = params.search_flank_len
    beg = max(0, region.start - flank_len)
    end = region.end + flank_len
    walked = bam.block_reader.extract(
        index.chunks_for(tid, beg, end), tid, beg, end, region,
        clip_radius, params.min_read_qual)
    if walked is None:
        return None
    blob, n_pass, n_filt = walked
    # the mapped primary records of the walk that overlap the locus's
    # fetch window, passed or filtered (not the records the walk skipped
    # before the window): a read counts for every locus it covers
    count("extract_records", n_pass + n_filt)

    if n_filt > 0:
        log.warning("%s: Quality filtered %d/%d reads", locus.id, n_filt,
                    n_filt + n_pass)

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

    with timed("extract.build"):
        return _deserialize(blob, region, keep)


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
