"""BGZF block-gzip codec (replaces htslib's bgzf; used for BAM and .vcf.gz).

Implements the BGZF subset of gzip defined by the SAM spec §4.1: each
block is an independent gzip member whose FEXTRA carries the compressed
block size, enabling virtual-offset random access (needed by .bai).
"""

import struct
import zlib
from typing import Optional

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HEADER = struct.Struct("<4BI2BH")  # magic1,magic2,CM,FLG,MTIME,XFL,OS,XLEN


class BgzfReader:
    """Sequential + virtual-offset random-access reader."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._block_offset = 0      # file offset of current block
        self._block_data = b""
        self._within = 0            # offset within current block

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _load_block_at(self, file_offset: int) -> bool:
        self._fh.seek(file_offset)
        header = self._fh.read(12)
        if len(header) == 0:
            self._block_data = b""
            self._within = 0
            return False
        if len(header) < 12:
            raise IOError("Truncated BGZF block header")
        magic1, magic2, cm, flg, _mtime, _xfl, _os, xlen = _HEADER.unpack(header)
        if magic1 != 0x1F or magic2 != 0x8B or cm != 8 or not (flg & 4):
            raise IOError("Invalid BGZF block magic")
        extra = self._fh.read(xlen)
        bsize = None
        pos = 0
        while pos + 4 <= len(extra):
            si1, si2, slen = extra[pos], extra[pos + 1], struct.unpack(
                "<H", extra[pos + 2:pos + 4])[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack("<H", extra[pos + 4:pos + 6])[0] + 1
            pos += 4 + slen
        if bsize is None:
            raise IOError("BGZF block missing BC subfield")
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fh.read(cdata_len)
        footer = self._fh.read(8)
        isize = struct.unpack("<I", footer[4:8])[0]
        self._block_data = zlib.decompress(cdata, -15, isize or 1)
        self._block_offset = file_offset
        self._next_offset = file_offset + bsize
        self._within = 0
        return True

    def seek_virtual(self, voffset: int):
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        if not self._load_block_at(coffset):
            raise IOError("BGZF seek past EOF")
        self._within = uoffset

    def tell_virtual(self) -> int:
        return (self._block_offset << 16) | self._within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._block_data) - self._within
            if avail == 0:
                next_off = getattr(self, "_next_offset", 0)
                if not self._load_block_at(next_off):
                    break
                if len(self._block_data) == 0:
                    continue
                avail = len(self._block_data)
            take = min(avail, n)
            out += self._block_data[self._within:self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def read_all(self) -> bytes:
        """Decompress the whole stream (fast path for whole-file scans).
        Uses the native C++ codec when available."""
        from .native import bgzf_read_file
        path = getattr(self._fh, "name", None)
        if isinstance(path, str):
            data = bgzf_read_file(path)
            if data is not None:
                return data
        self._fh.seek(0)
        raw = self._fh.read()
        out = []
        pos = 0
        n = len(raw)
        while pos < n:
            if n - pos < 28:
                break
            xlen = struct.unpack("<H", raw[pos + 10:pos + 12])[0]
            extra = raw[pos + 12:pos + 12 + xlen]
            bsize = None
            epos = 0
            while epos + 4 <= len(extra):
                si1, si2, slen = extra[epos], extra[epos + 1], struct.unpack(
                    "<H", extra[epos + 2:epos + 4])[0]
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack(
                        "<H", extra[epos + 4:epos + 6])[0] + 1
                epos += 4 + slen
            if bsize is None:
                raise IOError("BGZF block missing BC subfield")
            cdata = raw[pos + 12 + xlen:pos + bsize - 8]
            isize = struct.unpack("<I", raw[pos + bsize - 4:pos + bsize])[0]
            if isize:
                out.append(zlib.decompress(cdata, -15, isize))
            pos += bsize
        return b"".join(out)


class BgzfWriter:
    MAX_BLOCK = 65280

    def __init__(self, path_or_fh, level: int = 6):
        if isinstance(path_or_fh, str):
            self._fh = open(path_or_fh, "wb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self._level = level
        self._buf = bytearray()
        self._compressed_bytes = 0

    def tell_virtual(self) -> int:
        """Virtual file offset of the next byte to be written (valid when
        the pending buffer is < 64KiB, which write() guarantees)."""
        return (self._compressed_bytes << 16) | len(self._buf)

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= self.MAX_BLOCK:
            self._flush_block(self._buf[:self.MAX_BLOCK])
            del self._buf[:self.MAX_BLOCK]

    def _flush_block(self, data: bytes):
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(data)) + co.flush()
        bsize = len(cdata) + 26
        header = struct.pack(
            "<4BI2BH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        extra = struct.pack("<2BHH", 66, 67, 2, bsize - 1)
        footer = struct.pack("<II", zlib.crc32(bytes(data)) & 0xFFFFFFFF,
                             len(data))
        block = header + extra + cdata + footer
        self._fh.write(block)
        self._compressed_bytes += len(block)

    def flush(self):
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()

    def close(self):
        self.flush()
        self._fh.write(BGZF_EOF)
        if self._owns:
            self._fh.close()
        else:
            self._fh.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
