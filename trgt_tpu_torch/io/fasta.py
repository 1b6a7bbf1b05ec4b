"""faidx-indexed FASTA reader (replaces htslib faidx; ref: src/utils/readers.rs:28-39).

Pure host-side I/O: random access via the .fai index, no dependency on
htslib. The .fai format is five TSV columns:
    name  length  offset  linebases  linewidth
"""

import os
from typing import Dict, List, Tuple


class FastaReader:
    def __init__(self, path: str):
        self.path = path
        ext = os.path.splitext(path)[1]
        fai_path = path + ".fai"
        if not os.path.exists(fai_path):
            raise FileNotFoundError(
                f"Reference index file not found: {fai_path}. "
                f"Create it using 'samtools faidx {path}'")
        self._index: Dict[str, Tuple[int, int, int, int]] = {}
        self._order: List[str] = []
        with open(fai_path) as fh:
            for line in fh:
                fields = line.rstrip("\n").split("\t")
                name = fields[0]
                length, offset, linebases, linewidth = map(int, fields[1:5])
                self._index[name] = (length, offset, linebases, linewidth)
                self._order.append(name)
        self._fh = open(path, "rb")

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def references(self) -> List[str]:
        return list(self._order)

    def get_length(self, name: str) -> int:
        return self._index[name][0]

    def chrom_lookup(self) -> Dict[str, int]:
        """name -> sequence length (ref: src/trgt/locus.rs:78-93)."""
        return {name: rec[0] for name, rec in self._index.items()}

    def fetch(self, name: str, start: int, end: int) -> str:
        """Fetch [start, end) 0-based half-open; raw case preserved."""
        if name not in self._index:
            raise KeyError(f"Unknown sequence: {name}")
        length, offset, linebases, linewidth = self._index[name]
        start = max(0, start)
        end = min(end, length)
        if start >= end:
            return ""
        line_start = start // linebases
        byte_start = offset + line_start * linewidth + (start % linebases)
        line_end = (end - 1) // linebases
        byte_end = offset + line_end * linewidth + ((end - 1) % linebases) + 1
        self._fh.seek(byte_start)
        raw = self._fh.read(byte_end - byte_start)
        return raw.translate(None, b"\r\n").decode("ascii")
