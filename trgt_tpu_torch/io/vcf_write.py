"""VCF writer replicating TRGT's output byte-for-byte
(ref: src/trgt/writers/write_vcf.rs)."""

from typing import List, Optional, Tuple

from .bgzf import BgzfWriter

# ref: write_vcf.rs:20-33
VCF_LINES = [
    '##INFO=<ID=TRID,Number=1,Type=String,Description="Tandem repeat ID">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the '
    'variant described in this record">',
    '##INFO=<ID=MOTIFS,Number=.,Type=String,Description="Motifs that the '
    'tandem repeat is composed of">',
    '##INFO=<ID=STRUC,Number=1,Type=String,Description="Structure of the '
    'region">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=AL,Number=.,Type=Integer,Description="Length of each '
    'allele">',
    '##FORMAT=<ID=ALLR,Number=.,Type=String,Description="Length range per '
    'allele">',
    '##FORMAT=<ID=SD,Number=.,Type=Integer,Description="Number of spanning '
    'reads supporting per allele">',
    '##FORMAT=<ID=MC,Number=.,Type=String,Description="Motif counts per '
    'allele">',
    '##FORMAT=<ID=MS,Number=.,Type=String,Description="Motif spans per '
    'allele">',
    '##FORMAT=<ID=AP,Number=.,Type=Float,Description="Allele purity per '
    'allele">',
    '##FORMAT=<ID=AM,Number=.,Type=Float,Description="Mean methylation '
    'level per allele">',
]


def _fmt_float(value: float, decimals: int) -> str:
    # Rust's {:.N} rounds half-to-even like Python's format
    return f"{value:.{decimals}f}"


class VcfWriter:
    def __init__(self, path: str, sample_name: str,
                 contigs: List[Tuple[str, int]],
                 command_line: str, version: str,
                 program_name: str = "trgt"):
        self._bgzf = BgzfWriter(path) if path.endswith(".gz") else None
        self._fh = open(path, "wb") if self._bgzf is None else None
        lines = ["##fileformat=VCFv4.2",
                 '##FILTER=<ID=PASS,Description="All filters passed">']
        lines.extend(VCF_LINES)
        for name, length in contigs:
            lines.append(f"##contig=<ID={name},length={length}>")
        lines.append(f"##{program_name}Version={version}")
        lines.append(f"##{program_name}Command={command_line}")
        lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                     + sample_name)
        self._write("\n".join(lines) + "\n")

    def _write(self, text: str):
        data = text.encode("utf-8")
        if self._bgzf is not None:
            self._bgzf.write(data)
        else:
            self._fh.write(data)

    def close(self):
        if self._bgzf is not None:
            self._bgzf.close()
        else:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_bytes(self, data: bytes) -> None:
        """Append a pre-rendered record line (multiprocess worker path)."""
        if self._bgzf is not None:
            self._bgzf.write(data)
        else:
            self._fh.write(data)

    def write(self, locus, result) -> None:
        """locus: io.catalog.Locus; result: engine.workflow.LocusResult."""
        self._write(self.render(locus, result))

    @staticmethod
    def render(locus, result) -> str:
        """Render one VCF record line (without writing); the -t N
        worker processes ship rendered lines to the parent writer."""
        info = (f"TRID={locus.id};END={locus.region.end};"
                f"MOTIFS={','.join(locus.motifs)};STRUC={locus.struc}")
        pos = max(0, locus.region.start - 1)  # padding base before the TR
        pad_base = locus.left_flank[-1]
        fmt = "GT:AL:ALLR:SD:MC:MS:AP:AM"

        genotype = result.genotype
        if not genotype:
            # ref: write_vcf.rs:137-161 missing-GT record
            ref_seq = pad_base + locus.tr
            sample = "./.:.:.:.:.:.:.:."
            row = [locus.region.contig, str(pos + 1), ".", ref_seq, ".", ".",
                   ".", info, fmt, sample]
            return "\t".join(row) + "\n"

        # GT allele dedup + padding (ref: write_vcf.rs:219-259)
        seqs = [locus.tr]
        indexes = []
        for allele in genotype:
            if allele.seq == locus.tr:
                indexes.append(0)
            elif len(seqs) == 1:
                indexes.append(1)
                seqs.append(allele.seq)
            elif genotype[0].seq == genotype[1].seq:
                indexes.append(1)
            else:
                indexes.append(2)
                seqs.append(allele.seq)

        ref_seq = pad_base + seqs[0]
        alts = [pad_base + s for s in seqs[1:]]
        alt_field = ",".join(alts) if alts else "."
        gt_field = "/".join(str(i) for i in indexes)

        al = ",".join(str(len(a.seq)) for a in genotype)
        allr = ",".join(f"{a.ci[0]}-{a.ci[1]}" for a in genotype)
        sd = ",".join(str(a.num_spanning) for a in genotype)
        mc = ",".join("_".join(str(c) for c in a.annotation.motif_counts)
                      for a in genotype)
        ms_parts = []
        for a in genotype:
            if a.annotation.labels is None:
                ms_parts.append(".")
            else:
                ms_parts.append("_".join(
                    f"{s.motif_index}({s.start}-{s.end})"
                    for s in a.annotation.labels))
        ms = ",".join(ms_parts)
        ap = ",".join(
            "." if a.annotation.purity != a.annotation.purity
            else _fmt_float(a.annotation.purity, 6) for a in genotype)
        am = ",".join(
            "." if a.meth is None else _fmt_float(a.meth, 2)
            for a in genotype)

        sample = ":".join([gt_field, al, allr, sd, mc, ms, ap, am])
        row = [locus.region.contig, str(pos + 1), ".", ref_seq, alt_field,
               ".", ".", info, fmt, sample]
        return "\t".join(row) + "\n"
