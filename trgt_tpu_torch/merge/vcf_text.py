"""VCF reading for the merge pipeline (ref: src/merge/vcf_reader.rs).

Text-level reader over plain or BGZF-compressed VCFs with TRGT version
sniffing (trgtVersion header, else ALCI / ALLR+integer-AM heuristics →
0.3.4 / 0.4.0, ref vcf_reader.rs:127-176) and the pre-1.0 POS-shift
compatibility rule (vcf_reader.rs:108-124).

STREAMING: text inputs are parsed lazily — `records(contig)` yields
records one at a time from the open file, so merge memory stays flat in
input size (the reference's htslib per-contig iterators,
vcf_processor.rs:237-337, have the same property). This requires the
input to be position-sorted with contig blocks in a consistent order
(what `bcftools sort` produces and what the reference's index-required
inputs already guarantee); disorder raises instead of silently merging
wrong. Pre-1.0 files stream through a bounded lookahead buffer: the
POS shift is at most -1, so a record may be emitted once a raw record
with pos >= emitted.pos + 2 has been read. BCF inputs stream too:
records decode one at a time from the incrementally-inflated container
(io/bcf.BcfStreamReader) through the same machinery."""

import gzip
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


@dataclass
class VcfRecord:
    chrom: str
    pos: int                      # 0-based (VCF POS - 1, htslib convention)
    id: str
    alleles: List[str]            # [ref, alt...]; alt "." → just [ref]
    qual: str
    filter: str
    info: str
    fmt_keys: List[str]
    samples: List[Dict[str, str]]  # per sample: key -> raw string

    def info_field(self, key: str) -> Optional[str]:
        for part in self.info.split(";"):
            if part.startswith(key + "="):
                return part[len(key) + 1:]
        return None


def parse_version(v: str) -> Tuple[int, int, int]:
    m = re.match(r"^(\d+)\.(\d+)\.(\d+)", v)
    if not m:
        raise ValueError(f"Failed to parse version: {v}")
    return tuple(int(x) for x in m.groups())


class VcfTextReader:
    def __init__(self, path: str, index: int = 0):
        self.path = path
        self.index = index
        self.header_lines: List[str] = []
        self.samples: List[str] = []
        self._fh = None
        self._bcf_gen = None
        self._pending: Optional[VcfRecord] = None
        self._closed: set = set()
        # contig -> raw records of a block that appeared in the file
        # before its request turn (header-order mismatch fallback)
        self._spilled: Dict[str, List[VcfRecord]] = {}
        if self._is_bcf(path):
            self._open_bcf_stream(path)
        else:
            self._open_stream(path)
        self.version = self._sniff_version()
        self.sample_n = len(self.samples)

    # ---- loading ----
    def _open_lines(self, path: str):
        lower = path.lower()
        if lower.endswith(".gz") or lower.endswith(".bgz"):
            # BGZF is valid gzip; gzip module handles multi-member streams
            return gzip.open(path, "rt")
        return open(path)

    def _is_bcf(self, path: str) -> bool:
        with open(path, "rb") as fh:
            head = fh.read(5)
        if head[:5] == b"BCF\x02\x02":
            return True
        if head[:2] == b"\x1f\x8b":
            with gzip.open(path, "rb") as fh:
                return fh.read(5) == b"BCF\x02\x02"
        return False

    def _open_bcf_stream(self, path: str) -> None:
        """Streaming BCF input: records decode lazily from the
        incrementally-inflated container (io/bcf.BcfStreamReader), so
        merge memory stays flat for BCF inputs too."""
        from ..io.bcf import (BcfStreamReader, FLOAT_MISSING, FLOAT_EOV,
                              INT8_MISSING, INT8_EOV, INT16_MISSING,
                              INT16_EOV, INT32_MISSING, INT32_EOV)
        import struct as _struct
        reader = BcfStreamReader(path)
        self.header_lines = [l for l in reader.header_lines
                             if l.startswith("##")]
        self.samples = reader.samples

        int_missing = {1: INT8_MISSING, 2: INT16_MISSING, 3: INT32_MISSING}
        int_eov = {1: INT8_EOV, 2: INT16_EOV, 3: INT32_EOV}

        def ints_to_str(btype, vals):
            out = []
            for v in vals:
                if v == int_eov.get(btype):
                    break
                out.append("." if v == int_missing.get(btype) else str(v))
            return ",".join(out) if out else "."

        def floats_to_str(vals):
            out = []
            for bits in vals:
                if bits == FLOAT_EOV:
                    break
                if bits == FLOAT_MISSING:
                    out.append(".")
                else:
                    out.append(f"{_struct.unpack('<f', _struct.pack('<I', bits))[0]:g}")
            return ",".join(out) if out else "."

        def gt_to_str(btype, vals):
            parts = []
            for i, v in enumerate(vals):
                if v == int_eov.get(btype):
                    break
                phased = v & 1
                idx = (v >> 1) - 1
                sep = "" if i == 0 else ("|" if phased else "/")
                parts.append(sep + ("." if idx < 0 else str(idx)))
            return "".join(parts) if parts else "."

        def convert():
            for raw in reader.records():
                info_parts = []
                for key, val in raw["info"].items():
                    if isinstance(val, str):
                        info_parts.append(f"{key}={val}")
                    else:
                        btype, vals = val
                        info_parts.append(
                            f"{key}={ints_to_str(btype, vals)}")
                fmt_keys = list(raw["fmt"].keys())
                samples = []
                for s in range(raw["n_sample"]):
                    d = {}
                    for key, per_sample in raw["fmt"].items():
                        v = per_sample[s]
                        if key == "GT":
                            d[key] = gt_to_str(v[0], v[1])
                        elif isinstance(v, str):
                            d[key] = v if v else "."
                        else:
                            btype, vals = v
                            if btype == 5:
                                d[key] = floats_to_str(vals)
                            else:
                                d[key] = ints_to_str(btype, vals)
                    samples.append(d)
                yield VcfRecord(
                    chrom=raw["chrom"], pos=raw["pos"], id=raw["id"],
                    alleles=list(raw["alleles"]), qual=".", filter=".",
                    info=";".join(info_parts), fmt_keys=fmt_keys,
                    samples=samples)
            reader.close()

        self._bcf_gen = convert()

    def _open_stream(self, path: str) -> None:
        """Parse the header eagerly; leave the file positioned at the
        first record for lazy streaming."""
        self._fh = self._open_lines(path)
        first = True
        for line in self._fh:
            line = line.rstrip("\n")
            if first:
                if not line.startswith("##fileformat=VCFv"):
                    self._fh.close()
                    self._fh = None
                    raise ValueError(
                        f"File {path} is not a valid VCF file")
                first = False
            if line.startswith("##"):
                self.header_lines.append(line)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                self.samples = cols[9:]
                return
            elif line:
                # record before #CHROM (malformed but tolerated):
                # buffer it and start streaming
                self._pending = self._parse_record(line)
                return
        self._fh.close()
        self._fh = None

    def _next_raw(self) -> Optional[VcfRecord]:
        if self._pending is not None:
            rec = self._pending
            self._pending = None
            return rec
        if self._bcf_gen is not None:
            return next(self._bcf_gen, None)
        if self._fh is None:
            return None
        for line in self._fh:
            line = line.rstrip("\n")
            if line:
                return self._parse_record(line)
        self._fh.close()
        self._fh = None
        return None

    def _parse_record(self, line: str) -> VcfRecord:
        cols = line.split("\t")
        chrom, pos, rid, ref, alt, qual, filt, info = cols[:8]
        fmt_keys = cols[8].split(":") if len(cols) > 8 else []
        samples = []
        for s in cols[9:]:
            vals = s.split(":")
            samples.append({k: (vals[i] if i < len(vals) else ".")
                            for i, k in enumerate(fmt_keys)})
        alleles = [ref]
        if alt != ".":
            alleles.extend(alt.split(","))
        return VcfRecord(chrom, int(pos) - 1, rid, alleles, qual, filt,
                         info, fmt_keys, samples)

    # ---- version handling ----
    def _sniff_version(self) -> Tuple[int, int, int]:
        trgt_version = None
        for line in self.header_lines:
            if line.startswith("##trgtVersion="):
                trgt_version = line.split("=", 1)[1]
        if trgt_version is None:
            has_allr = False
            has_alci = False
            is_integer_am = False
            for line in self.header_lines:
                if line.startswith("##FORMAT="):
                    if "ID=ALLR" in line:
                        has_allr = True
                    if "ID=ALCI" in line:
                        has_alci = True
                    if "ID=AM" in line and "Type=Integer" in line:
                        is_integer_am = True
            if has_alci:
                trgt_version = "0.3.4"
            elif has_allr and is_integer_am:
                trgt_version = "0.4.0"
            if trgt_version is None:
                raise ValueError(f"Non-TRGT VCF supplied {self.path}")
        return parse_version(trgt_version)

    # ---- access ----
    def contigs(self) -> List[Tuple[str, int]]:
        out = []
        for line in self.header_lines:
            if line.startswith("##contig=<"):
                body = line[len("##contig=<"):-1]
                fields = dict(kv.split("=", 1) for kv in body.split(",")
                              if "=" in kv)
                out.append((fields.get("ID", ""),
                            int(fields.get("length", "0") or 0)))
        return out

    def _header_rank(self) -> Dict[str, int]:
        if not hasattr(self, "_rank_cache"):
            self._rank_cache = {cid: i for i, (cid, _)
                                in enumerate(self.contigs())}
        return self._rank_cache

    def records(self, contig: str, scan: bool = False,
                upcoming: Optional[set] = None) -> Iterator[VcfRecord]:
        """Stream the records of `contig`.

        scan=False (merge): callers iterate contigs in the merge-union
        order and each block is consumed exactly once. When the file's
        next block is a DIFFERENT contig, the header contig order
        decides: if `contig` ranks later in this file's header, the
        requested block may still be ahead, so foreign blocks are read
        forward — dropped when they are not in `upcoming` (the set of
        contigs the caller will still request, e.g. after a --contigs
        filter) or spilled into a per-block memory buffer when they
        will be requested later (header-order mismatch between files).
        If `contig` ranks earlier, it is absent from this file and the
        pending block is preserved for the next request.

        scan=True (plot): skip forward past other contigs until
        `contig` is found (single-shot use).

        Position disorder within a contig, or a contig block appearing
        after its turn has passed, raises ValueError — silently merging
        unsorted input would produce wrong output (the reference
        requires indexed, i.e. sorted, inputs: vcf_reader.rs:19-50)."""
        spilled = self._spilled.pop(contig, None)
        if spilled is not None:
            if self.version[0] < 1:
                for r in spilled:
                    self._apply_shift_one(r)
                spilled.sort(key=lambda r: r.pos)
            yield from spilled
            return
        if self.version[0] < 1:
            yield from self._stream_pre10(contig, scan, upcoming)
            return
        yield from self._stream(contig, scan, upcoming)

    def _skip_block(self, first: VcfRecord,
                    sink: Optional[List[VcfRecord]]) -> None:
        """Consume the rest of `first`'s contig block (validating
        position order), appending to `sink` when spilling; leaves the
        first record of the following block pending."""
        self._closed.add(first.chrom)
        if sink is not None:
            sink.append(first)
        last = first.pos
        while True:
            rec = self._next_raw()
            if rec is None:
                return
            if rec.chrom != first.chrom:
                self._pending = rec
                return
            if rec.pos < last:
                raise ValueError(
                    f"{self.path}: records at {first.chrom}:{rec.pos + 1} "
                    f"are not position-sorted; sort the VCF "
                    f"(e.g. bcftools sort)")
            last = rec.pos
            if sink is not None:
                sink.append(rec)

    def _stream(self, contig: str, scan: bool,
                upcoming: Optional[set] = None) -> Iterator[VcfRecord]:
        last_pos = None
        started = False
        while True:
            rec = self._next_raw()
            if rec is None:
                self._closed.add(contig)
                return
            if rec.chrom != contig:
                if rec.chrom in self._closed:
                    raise ValueError(
                        f"{self.path}: contig {rec.chrom!r} records "
                        f"appear out of order; sort the VCF "
                        f"(e.g. bcftools sort)")
                if scan and not started:
                    # skip-forward mode: blocks before the target are
                    # consumed and closed
                    self._closed.add(rec.chrom)
                    continue
                rank = self._header_rank()
                if (not started and contig in rank
                        and rank.get(rec.chrom, -1) < rank[contig]):
                    # requested block may still be ahead in this file:
                    # read forward, spilling blocks that will be
                    # requested later, dropping ones that never will
                    sink = None
                    if upcoming is None or rec.chrom in upcoming:
                        sink = self._spilled.setdefault(rec.chrom, [])
                    self._skip_block(rec, sink)
                    continue
                self._pending = rec
                self._closed.add(contig)
                return
            if contig in self._closed:
                raise ValueError(
                    f"{self.path}: contig {contig!r} records appear "
                    f"out of order; sort the VCF (e.g. bcftools sort)")
            started = True
            if last_pos is not None and rec.pos < last_pos:
                raise ValueError(
                    f"{self.path}: records at {contig}:{rec.pos + 1} "
                    f"are not position-sorted; sort the VCF "
                    f"(e.g. bcftools sort)")
            last_pos = rec.pos
            yield rec

    def _stream_pre10(self, contig: str, scan: bool,
                      upcoming: Optional[set] = None
                      ) -> Iterator[VcfRecord]:
        """Pre-1.0 streaming: apply the POS shift record-by-record
        through a bounded lookahead heap. The shift is at most -1, so a
        buffered record with final pos p is safe to emit once a raw
        record with pos >= p + 2 has been seen (any later record's
        final pos is >= its raw pos - 1 > p)."""
        import heapq
        buf: List[Tuple[int, int, VcfRecord]] = []
        seq = 0
        for rec in self._stream(contig, scan, upcoming):
            self._apply_shift_one(rec)
            heapq.heappush(buf, (rec.pos, seq, rec))
            seq += 1
            # rec.pos here is the shifted pos; raw was >= rec.pos
            while buf and buf[0][0] + 2 <= rec.pos:
                yield heapq.heappop(buf)[2]
        while buf:
            yield heapq.heappop(buf)[2]

    def _apply_shift_one(self, rec: VcfRecord) -> None:
        al = rec.samples[0].get("AL", ".") if rec.samples else "."
        try:
            al_min = min(int(x) for x in al.split(",") if x != ".")
        except ValueError:
            return
        if al_min != 0:
            rec.pos -= 1
