"""`merge` command: k-way streaming merge of TRGT VCFs
(ref: src/merge/vcf_processor.rs).

Semantic port of the reference merge: per-contig min-heap over sorted
per-sample records, exact allele-union merge strategy with GT index
remapping, pre-1.0 padding-base compatibility, and skip-and-log error
handling (--quit-on-errors to abort)."""

import heapq
import logging
import re
import sys
from typing import Dict, List, Optional, Tuple

from .. import FULL_VERSION
from ..io.bgzf import BgzfWriter
from ..io.fasta import FastaReader
from .exact import merge_exact
from .vcf_text import VcfRecord, VcfTextReader

log = logging.getLogger("trgt")
PROGRAM_NAME = "trgt"

FMT_KEYS = ["GT", "AL", "ALLR", "SD", "MC", "MS", "AP", "AM"]


def parse_gt(gt: str):
    """'0/1', '0|1', '.', './.' → [(idx or None, phased), ...]"""
    out = []
    phased = False
    token = ""
    for c in gt:
        if c in "/|":
            out.append((None if token == "." else int(token), phased))
            phased = c == "|"
            token = ""
        else:
            token += c
    out.append((None if token == "." else int(token), phased))
    return out


def render_gt(alleles) -> str:
    parts = []
    for i, (idx, phased) in enumerate(alleles):
        sep = "" if i == 0 else ("|" if phased else "/")
        parts.append(sep + ("." if idx is None else str(idx)))
    return "".join(parts)


def process_vcf_paths(args) -> List[str]:
    # ref: cli.rs:662-696 MergeArgs::process_vcf_paths
    if args.vcfs:
        return list(args.vcfs)
    if args.vcf_list:
        paths = []
        with open(args.vcf_list) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    paths.append(line)
        return paths
    raise ValueError("No VCF files provided")


def _merge_headers(readers: List[VcfTextReader], args) -> List[str]:
    """Union of header definitions, first-seen wins (bcf_hdr_merge
    semantics, ref vcf_reader.rs:224-255) with ALCI/AM normalization
    (vcf_processor.rs:200-214)."""
    lines: List[str] = ["##fileformat=VCFv4.2",
                       '##FILTER=<ID=PASS,Description="All filters passed">']
    seen = set(["fileformat", "FILTER:PASS"])

    def key_of(line: str) -> Optional[str]:
        m = re.match(r"^##(INFO|FORMAT|FILTER|contig)=<ID=([^,>]+)", line)
        if m:
            return f"{m.group(1)}:{m.group(2)}"
        m = re.match(r"^##([^=]+)=", line)
        if m:
            return f"generic:{m.group(1)}:{line}"
        return None

    for reader in readers:
        for line in reader.header_lines:
            if line.startswith("##fileformat"):
                continue
            k = key_of(line)
            if k is None or k in seen:
                continue
            # normalize legacy formats away (removed and re-added below)
            if k in ("FORMAT:ALCI", "FORMAT:AM", "FORMAT:ALLR"):
                seen.add(k)
                continue
            # drop per-input provenance lines; new ones are added below
            if line.startswith(f"##{PROGRAM_NAME}Version=") or \
                    line.startswith(f"##{PROGRAM_NAME}Command="):
                continue
            seen.add(k)
            lines.append(line)

    lines.append('##FORMAT=<ID=ALLR,Number=.,Type=String,'
                 'Description="Length range per allele">')
    lines.append('##FORMAT=<ID=AM,Number=.,Type=Float,'
                 'Description="Mean methylation level per allele">')
    if not args.no_version:
        lines.append(f"##{PROGRAM_NAME}Version={FULL_VERSION}")
        lines.append(f"##{PROGRAM_NAME}Command={' '.join(sys.argv)}")
    return lines


def _contig_order(readers: List[VcfTextReader]) -> List[str]:
    # ref: vcf_reader.rs:193-222
    order: List[str] = []
    lengths: Dict[str, set] = {}
    for reader in readers:
        for cid, length in reader.contigs():
            if cid not in lengths:
                order.append(cid)
                lengths[cid] = set()
            lengths[cid].add(length)
    for cid in order:
        if len(lengths[cid]) > 1:
            raise ValueError(
                f"Inconsistent contig definitions found in VCF headers: "
                f"Contig '{cid}' is defined with multiple lengths: "
                f"{sorted(lengths[cid])}")
    return order


def _legacy_am_to_float(am: str) -> str:
    # ref: vcf_processor.rs:629-661 — integer AM / 255 → float
    parts = []
    for tok in am.split(","):
        if tok == "." or tok == "":
            parts.append(".")
        else:
            try:
                parts.append(f"{int(tok) / 255.0:g}")
            except ValueError:
                parts.append(tok)
    return ",".join(parts)


def _sample_fields(rec: VcfRecord, version) -> List[Dict[str, str]]:
    out = []
    for s in rec.samples:
        d = dict(s)
        if "ALLR" not in d and "ALCI" in d:
            d["ALLR"] = d["ALCI"]
        if version <= (0, 4, 0) and "AM" in d:
            d["AM"] = _legacy_am_to_float(d["AM"])
        out.append(d)
    return out


def run_merge(args) -> None:
    vcfs = process_vcf_paths(args)
    readers = [VcfTextReader(p, i) for i, p in enumerate(vcfs)]
    if len(readers) == 1 and not args.force_single:
        raise ValueError(
            "Expected two or more files to merge, got only one. "
            "Use --force-single to proceed anyway")

    # duplicate sample detection (ref: vcf_reader.rs:233-247)
    observed = set()
    all_samples = []
    for reader in readers:
        for s in reader.samples:
            if s in observed:
                if args.force_samples:
                    continue
                raise ValueError(f"Duplicate sample ID found: {s}")
            observed.add(s)
            all_samples.append(s)

    contig_order = _contig_order(readers)
    if args.contigs:
        missing = set(args.contigs) - set(contig_order)
        if missing:
            raise ValueError(
                f"The following user-specified contigs do not exist in "
                f"the VCF files: {sorted(missing)}")
        contig_order = [c for c in contig_order if c in set(args.contigs)]

    needs_padding = any(r.version[0] < 1 for r in readers)
    genome = None
    if needs_padding:
        if not args.genome_path:
            raise ValueError(
                "A reference genome is required for merging pre v1.0 TRGT "
                "VCFs, provide as --genome ref.fa")
        genome = FastaReader(args.genome_path)

    header_lines = _merge_headers(readers, args)
    header_lines.append(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(all_samples))

    out_type = args.output_type
    if out_type is None and args.output:
        lower = args.output.lower()
        if lower.endswith(".bcf.gz") or lower.endswith(".bcf"):
            out_type = "b" if lower.endswith(".bcf.gz") else "u"
            if lower.endswith(".bcf"):
                out_type = "u"
        elif lower.endswith(".vcf.gz") or lower.endswith(".vcf.bgz"):
            out_type = "z"
        else:
            out_type = "v"

    bcf_writer = None
    sink = None
    if out_type in ("u", "b"):
        from ..io.bcf import BcfWriter
        bcf_writer = BcfWriter(args.output, header_lines,
                               uncompressed=(out_type == "u"))
        write = None
    elif args.output:
        if out_type == "z":
            sink = BgzfWriter(args.output)
            write = lambda s: sink.write(s.encode())
        else:
            sink = open(args.output, "w")
            write = sink.write
    else:
        write = sys.stdout.write

    if args.print_header:
        if write is not None:
            write("\n".join(header_lines) + "\n")
        if sink is not None:
            sink.close()
        if bcf_writer is not None:
            bcf_writer.close()
        return

    if write is not None:
        write("\n".join(header_lines) + "\n")

    n = 0
    n_processed = 0
    n_failed = 0
    skip_n = args.skip_n or 0
    process_n = args.process_n if args.process_n is not None else float("inf")

    done = False
    for ci, contig in enumerate(contig_order):
        if done:
            break
        # contigs still to be requested: the streaming reader uses this
        # to drop blocks that will never be asked for (--contigs filter)
        # and spill blocks that appear before their turn
        remaining = set(contig_order[ci:])
        iters = [iter(r.records(contig, upcoming=remaining))
                 for r in readers]
        heap: List[Tuple[int, int, VcfRecord]] = []
        for i, it in enumerate(iters):
            rec = next(it, None)
            if rec is not None:
                heapq.heappush(heap, (rec.pos, i, rec))
        while heap:
            min_pos = heap[0][0]
            sample_records: List[Optional[VcfRecord]] = [None] * len(readers)
            while heap and heap[0][0] == min_pos:
                _, i, rec = heapq.heappop(heap)
                sample_records[i] = rec
            if n >= skip_n:
                if needs_padding:
                    _add_padding_base(sample_records, readers, genome,
                                      contig, min_pos)
                try:
                    if bcf_writer is not None:
                        data = _merge_site_data(sample_records, readers,
                                                contig, min_pos)
                        _write_site_bcf(bcf_writer, data)
                    else:
                        line = _merge_site(sample_records, readers, contig,
                                           min_pos)
                        write(line + "\n")
                    n_processed += 1
                    if n_processed >= process_n:
                        done = True
                        break
                except Exception as e:
                    if args.quit_on_errors:
                        raise
                    n_failed += 1
                    log.warning("Failed to merge at %s:%d: %s Skipping...",
                                contig, min_pos, e)
            n += 1
            for i, rec in enumerate(sample_records):
                if rec is not None:
                    nxt = next(iters[i], None)
                    if nxt is not None:
                        heapq.heappush(heap, (nxt.pos, i, nxt))

    msg = f"Successfully merged {n_processed:,} TR sites."
    if n_failed > 0:
        msg += f" Failed to merge {n_failed:,} TR sites!"
    log.info(msg)
    if sink is not None:
        sink.close()
    if bcf_writer is not None:
        bcf_writer.close()


def _add_padding_base(sample_records, readers, genome, contig: str,
                      pos: int) -> None:
    # ref: vcf_processor.rs:339-388
    padding_base = genome.fetch(contig, pos, pos + 1).upper()
    for rec, reader in zip(sample_records, readers):
        if reader.version[0] >= 1 or rec is None:
            continue
        al = rec.samples[0].get("AL", ".") if rec.samples else "."
        try:
            al_min = min(int(x) for x in al.split(",") if x != ".")
        except ValueError:
            continue
        if al_min != 0:
            rec.alleles = [padding_base + a for a in rec.alleles]


def _merge_site_data(sample_records, readers, contig: str, pos: int):
    template = next(r for r in sample_records if r is not None)

    gt_vecs = []
    alleles = []
    fields_by_vcf: List[List[Dict[str, str]]] = []
    for i, rec in enumerate(sample_records):
        if rec is not None:
            alleles.append(rec.alleles)
            gt_vecs.append([parse_gt(s.get("GT", "."))
                            for s in rec.samples])
            fields_by_vcf.append(_sample_fields(rec, readers[i].version))
        else:
            alleles.append([])
            gt_vecs.append([[(None, False)]] * readers[i].sample_n)
            fields_by_vcf.append([
                {k: "." for k in FMT_KEYS}] * readers[i].sample_n)

    out_gts, out_alleles = merge_exact(gt_vecs, alleles)

    info_parts = []
    for key in ("TRID", "END", "MOTIFS", "STRUC"):
        val = template.info_field(key)
        if val is not None:
            info_parts.append(f"{key}={val}")
    info = ";".join(info_parts)

    ref = out_alleles[0]
    alt = ",".join(out_alleles[1:]) if len(out_alleles) > 1 else "."

    flat_gts = []
    flat_fields = []
    for vcf_gts, vcf_fields in zip(out_gts, fields_by_vcf):
        for sample_gt, fields in zip(vcf_gts, vcf_fields):
            flat_gts.append(sample_gt)
            flat_fields.append(fields)

    return dict(contig=contig, pos=pos, info=info, template=template,
                ref=ref, alt=alt, out_alleles=out_alleles,
                gts=flat_gts, fields=flat_fields)


def _merge_site(sample_records, readers, contig: str, pos: int) -> str:
    data = _merge_site_data(sample_records, readers, contig, pos)
    sample_cols = []
    for sample_gt, fields in zip(data["gts"], data["fields"]):
        col = [render_gt(sample_gt)]
        for key in FMT_KEYS[1:]:
            col.append(fields.get(key, "."))
        sample_cols.append(":".join(col))
    row = [contig, str(pos + 1), ".", data["ref"], data["alt"], ".", ".",
           data["info"], ":".join(FMT_KEYS)] + sample_cols
    return "\t".join(row)


def _ints_or_missing(s: str):
    from ..io.bcf import INT32_MISSING
    out = []
    for tok in s.split(","):
        out.append(INT32_MISSING if tok in (".", "") else int(tok))
    return out


def _floats_or_missing(s: str):
    out = []
    for tok in s.split(","):
        out.append(None if tok in (".", "") else float(tok))
    return out


def _write_site_bcf(bcf_writer, data):
    from ..io.bcf import BcfWriter
    template = data["template"]
    info = []
    for key in ("TRID", "END", "MOTIFS", "STRUC"):
        val = template.info_field(key)
        if val is None:
            continue
        info.append((key, int(val) if key == "END" else val))
    fields = data["fields"]
    fmt = [
        ("GT", BcfWriter.encode_format_gt(data["gts"])),
        ("AL", BcfWriter.encode_format_ints(
            [_ints_or_missing(f.get("AL", ".")) for f in fields])),
        ("ALLR", BcfWriter.encode_format_strings(
            [f.get("ALLR", ".") for f in fields])),
        ("SD", BcfWriter.encode_format_ints(
            [_ints_or_missing(f.get("SD", ".")) for f in fields])),
        ("MC", BcfWriter.encode_format_strings(
            [f.get("MC", ".") for f in fields])),
        ("MS", BcfWriter.encode_format_strings(
            [f.get("MS", ".") for f in fields])),
        ("AP", BcfWriter.encode_format_floats(
            [_floats_or_missing(f.get("AP", ".")) for f in fields])),
        ("AM", BcfWriter.encode_format_floats(
            [_floats_or_missing(f.get("AM", ".")) for f in fields])),
    ]
    bcf_writer.write_record(
        chrom=data["contig"], pos=data["pos"], rid=".",
        alleles=data["out_alleles"], qual=None, info=info, fmt=fmt,
        n_sample=len(fields))
