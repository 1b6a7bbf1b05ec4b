"""`merge` through the port's CLI: the merged VCF and BCF bytes equal
`trgt_tpu`'s, on VCFs that each package genotyped from the same synthetic
samples, under every output type and flag; then the unit cases of
tests/test_merge.py and the streaming-reader cases of
tests/test_merge_streaming.py, for both packages."""

import gzip
import importlib
import os
import random
import struct
import sys
from types import SimpleNamespace

import pytest
import torch

from trgt_tpu.cli import main as trgt_tpu_main
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.io.bgzf import BgzfReader
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset

torch.set_num_threads(1)

PACKAGES = ("trgt_tpu_torch", "trgt_tpu")
MAINS = {"trgt_tpu_torch": port_main, "trgt_tpu": trgt_tpu_main}

# one genome (the same loci and seed); per sample its own alleles, depth
# and read errors; the third sample's catalog lacks two loci, so some
# sites are private and some shared
LOCI = [("L1", "CAG", 10, None), ("L2", "AT", 12, None),
        ("L3", "CAGCCG", 6, "CAG,CCG"), ("L4", "GGC", 8, None),
        ("L5", "AAAG", 9, None)]
SAMPLES = [
    dict(alleles=[(10, 20), (12, 12), (6, 9), (8, 30), (9, 9)], depth=12,
         error_rate=0.0),
    dict(alleles=[(10, 14), (12, 15), (6, 6), (8, 8), (9, 12)], depth=10,
         error_rate=0.01),
    dict(alleles=[(20, 20), (10, 12), (7, 9), (8, 30), (9, 9)], depth=14,
         error_rate=0.0, drop=("L2", "L5")),
]


def sample_dataset(root, k):
    spec = SAMPLES[k]
    d = os.path.join(root, f"s{k}")
    os.makedirs(d)
    loci = [SynthLocus(lid, motif, ref, alleles, motifs=motifs)
            for (lid, motif, ref, motifs), alleles
            in zip(LOCI, spec["alleles"])]
    fasta, bed, bam = make_dataset(d, loci, depth=spec["depth"], seed=11,
                                   error_rate=spec["error_rate"])
    if "drop" in spec:
        lines = [line for line in open(bed)
                 if not any(f"ID={lid};" in line for lid in spec["drop"])]
        open(bed, "w").write("".join(lines))
    return fasta, bed, bam


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """{package: [VCF per sample]}: trgt_tpu's from `--device host`, the
    port's from `--device host` except the first sample's, which comes
    from `--device cpu` (its records equal the port's host run)."""
    root = str(tmp_path_factory.mktemp("torch_merge"))
    vcfs = {pkg: [] for pkg in PACKAGES}
    fastas = set()
    for k in range(len(SAMPLES)):
        fasta, bed, bam = sample_dataset(root, k)
        fastas.add(open(fasta).read())
        runs = [("trgt_tpu", "host"), ("trgt_tpu_torch", "host")]
        if k == 0:
            runs.append(("trgt_tpu_torch", "cpu"))
        out = {}
        for pkg, device in runs:
            prefix = os.path.join(root, f"s{k}_{pkg}_{device}")
            rc = MAINS[pkg](["genotype", "--genome", fasta, "--repeats",
                             bed, "--reads", bam, "--output-prefix", prefix,
                             "--sample-name", f"sample{k}", "--device",
                             device, "--disable-bam-output"])
            assert rc == 0
            out[pkg, device] = prefix + ".vcf.gz"
        if k == 0:
            assert body(out["trgt_tpu_torch", "cpu"]) == \
                body(out["trgt_tpu_torch", "host"])
        vcfs["trgt_tpu"].append(out["trgt_tpu", "host"])
        vcfs["trgt_tpu_torch"].append(out["trgt_tpu_torch",
                                          "cpu" if k == 0 else "host"])
    assert len(fastas) == 1
    return root, fasta, vcfs


def body(vcf_gz):
    with gzip.open(vcf_gz, "rt") as fh:
        return [line for line in fh if not line.startswith("##")]


def run(pkg, monkeypatch, argv):
    """The package's CLI, with a command line of its own in sys.argv (the
    merged header's ##trgtCommand= line records it)."""
    monkeypatch.setattr(sys, "argv", [f"{pkg}-cli", *argv])
    return MAINS[pkg](argv)


def drop_command(data: bytes, out_type: str) -> bytes:
    """Output bytes without the ##trgtCommand= header line: BGZF and BCF
    containers opened, the BCF header's text length adjusted."""
    if out_type in ("z", "b"):
        data = gzip.decompress(data)
    if out_type in ("b", "u"):
        assert data[:5] == b"BCF\x02\x02"
        (l_text,) = struct.unpack_from("<I", data, 5)
        text = data[9:9 + l_text]
        kept = b"".join(line for line in text.splitlines(keepends=True)
                        if not line.startswith(b"##trgtCommand="))
        return data[:5] + struct.pack("<I", len(kept)) + kept + \
            data[9 + l_text:]
    return b"".join(line for line in data.splitlines(keepends=True)
                    if not line.startswith(b"##trgtCommand="))


@pytest.mark.parametrize("no_version", [True, False])
@pytest.mark.parametrize("out_type", ["z", "b", "v", "u"])
def test_merge_bytes_equal(cohort, tmp_path, monkeypatch, out_type,
                           no_version):
    root, _fasta, vcfs = cohort
    got = {}
    for pkg in PACKAGES:
        out = str(tmp_path / f"{pkg}.out")
        argv = ["merge", "--vcf", *vcfs[pkg], "-o", out, "-O", out_type]
        if no_version:
            argv.append("--no-version")
        assert run(pkg, monkeypatch, argv) == 0
        got[pkg] = open(out, "rb").read()
    port, ref = got["trgt_tpu_torch"], got["trgt_tpu"]
    if no_version:
        assert port == ref
    else:
        assert port != ref          # the command lines differ
        assert drop_command(port, out_type) == drop_command(ref, out_type)
    if out_type in ("z", "v"):
        text = (BgzfReader(str(tmp_path / "trgt_tpu_torch.out")).read_all()
                if out_type == "z" else port).decode()
        records = [line.split("\t") for line in text.splitlines()
                   if not line.startswith("#")]
        # the five loci: three shared by all samples, two missing in one
        assert len(records) == 5
        assert sum(1 for r in records if r[11] == ".:.:.:.:.:.:.:.") == 2
        assert ("##trgtVersion=" in text) != no_version


def text_vcfs(tmp_path):
    """Two single-sample text VCFs over contigs c1 and c2 (the form of
    tests/test_merge_streaming.py)."""
    a = write(tmp_path, rec("c1", 10) + rec("c2", 5) + rec("c2", 40),
              name="a.vcf")
    b = write(tmp_path, rec("c1", 10, al="4,6") + rec("c2", 5),
              name="b.vcf")
    text = open(b).read()
    open(b, "w").write(text.replace("\ts1\n", "\ts2\n", 1))
    return [a, b]


MERGE_FLAG_CASES = {
    "skip_n": ["--skip-n", "2"],
    "process_n": ["--process-n", "3"],
    "skip_and_process_n": ["--skip-n", "1", "--process-n", "2"],
    "contig": ["--contig", "c2"],
    "contig_missing": ["--contig", "c9"],
    "force_samples": ["--force-samples"],
    "duplicate_samples": [],
    "missing_to_ref": ["--missing-to-ref"],
    "print_header": ["--print-header"],
    "vcf_list": [],
    "force_single": ["--force-single"],
    "single_without_force": [],
    "quit_on_errors": ["--quit-on-errors"],
}


@pytest.mark.parametrize("case", list(MERGE_FLAG_CASES))
def test_merge_flags_equal(cohort, tmp_path, monkeypatch, case):
    """One case per flag: the same exit code and output bytes."""
    root, _fasta, vcfs = cohort
    got = {}
    for pkg in PACKAGES:
        inputs = list(vcfs[pkg])
        if case.startswith("contig"):
            inputs = text_vcfs(tmp_path)
        elif case in ("force_samples", "duplicate_samples"):
            inputs = [inputs[0], inputs[0], inputs[1]]
        elif case in ("force_single", "single_without_force"):
            inputs = inputs[2:]
        out = str(tmp_path / f"{pkg}_{case}.vcf")
        argv = ["merge", "-o", out, "--no-version",
                *MERGE_FLAG_CASES[case]]
        if case == "vcf_list":
            listing = str(tmp_path / f"{pkg}.list")
            open(listing, "w").write("\n".join(inputs) + "\n")
            argv += ["--vcf-list", listing]
        else:
            argv += ["--vcf", *inputs]
        rc = run(pkg, monkeypatch, argv)
        got[pkg] = (rc, open(out, "rb").read() if os.path.exists(out)
                    else None)
    assert got["trgt_tpu_torch"] == got["trgt_tpu"]
    rc, data = got["trgt_tpu_torch"]
    failing = ("contig_missing", "duplicate_samples", "single_without_force")
    assert rc == (1 if case in failing else 0)
    if rc == 0:
        lines = data.decode().splitlines()
        n_records = sum(1 for line in lines if not line.startswith("#"))
        assert n_records == {"skip_n": 3, "process_n": 3,
                             "skip_and_process_n": 2, "contig": 2,
                             "print_header": 0, "force_single": 3}.get(
                                 case, 5)


def test_merge_bcf_round_trip_equal(cohort, tmp_path, monkeypatch):
    """VCFs → BCF → `--force-single` back to VCF: the same bytes in both
    packages, and the records of the direct merge to VCF."""
    _root, _fasta, vcfs = cohort
    got = {}
    for pkg in PACKAGES:
        bcf, back, direct = (str(tmp_path / f"{pkg}.{ext}")
                             for ext in ("bcf.gz", "back.vcf", "vcf"))
        assert run(pkg, monkeypatch, ["merge", "--vcf", *vcfs[pkg], "-o",
                                      bcf, "-O", "b"]) == 0
        assert run(pkg, monkeypatch, ["merge", "--vcf", bcf, "-o", back,
                                      "--force-single",
                                      "--no-version"]) == 0
        assert run(pkg, monkeypatch, ["merge", "--vcf", *vcfs[pkg], "-o",
                                      direct, "--no-version"]) == 0
        got[pkg] = open(back, "rb").read()
        records = [line for line in open(back) if not line.startswith("#")]
        want = [line for line in open(direct) if not line.startswith("#")]
        # BCF keeps AP/AM as float32: "1.000000" reads back as "1"
        assert [r.split("\t")[:9] for r in records] == \
            [w.split("\t")[:9] for w in want]
    assert got["trgt_tpu_torch"] == got["trgt_tpu"]


def legacy_inputs(tmp_path):
    """Two pre-1.0 VCFs (no ##trgtVersion, integer AM: the HDR_LEGACY
    form) and a genome for their padding bases."""
    rng = random.Random(5)
    seqs = {c: "".join(rng.choice("ACGT") for _ in range(600))
            for c in ("c1", "c2")}
    fasta = str(tmp_path / "legacy.fa")
    with open(fasta, "w") as fh, open(fasta + ".fai", "w") as fai:
        off = 0
        for c, s in seqs.items():
            fh.write(f">{c}\n{s}\n")
            off += len(c) + 2
            fai.write(f"{c}\t{len(s)}\t{off}\t{len(s)}\t{len(s) + 1}\n")
            off += len(s) + 1
    a = write(tmp_path, rec("c1", 100, al="0,5", am="10,200")
              + rec("c1", 100, al="3,3") + rec("c2", 200, al="4,4"),
              header=HDR_LEGACY, name="old_a.vcf")
    b = write(tmp_path, rec("c1", 99, al="3,3") + rec("c2", 200, al="4,6"),
              header=HDR_LEGACY, name="old_b.vcf")
    text = open(b).read()
    open(b, "w").write(text.replace("\ts1\n", "\ts2\n", 1))
    return fasta, [a, b]


@pytest.mark.parametrize("with_genome", [True, False])
def test_merge_pre10_padding_base(tmp_path, monkeypatch, with_genome):
    """Pre-1.0 inputs need -g for the padding base; without it both
    packages refuse."""
    fasta, inputs = legacy_inputs(tmp_path)
    got = {}
    for pkg in PACKAGES:
        out = str(tmp_path / f"{pkg}.vcf")
        argv = ["merge", "--vcf", *inputs, "-o", out, "--no-version"]
        if with_genome:
            argv += ["-g", fasta]
        rc = run(pkg, monkeypatch, argv)
        got[pkg] = (rc, open(out, "rb").read() if os.path.exists(out)
                    else None)
    assert got["trgt_tpu_torch"] == got["trgt_tpu"]
    assert got["trgt_tpu"][0] == (0 if with_genome else 1)
    if with_genome:
        records = [line.split("\t") for line in
                   got["trgt_tpu"][1].decode().splitlines()
                   if not line.startswith("#")]
        # POS shifted by one unless an allele length is 0; that record
        # keeps its REF, the others gain the genome's padding base; the
        # integer AM becomes a fraction of 255
        assert [(r[0], r[1]) for r in records] == \
            [("c1", "98"), ("c1", "99"), ("c1", "100"), ("c2", "199")]
        assert [r[3] for r in records].count("TCAG") == 1
        assert records[2][9].endswith(":0.0392157,0.784314")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_merge_duplicate_samples_rejected(cohort, pkg):
    _root, _fasta, vcfs = cohort
    args = SimpleNamespace(
        vcfs=[vcfs[pkg][0], vcfs[pkg][0]], vcf_list=None, genome_path=None,
        output=None, output_type=None, skip_n=None, process_n=None,
        print_header=False, force_single=False, force_samples=False,
        no_version=False, missing_to_ref=False, strategy="exact",
        quit_on_errors=False, contigs=None)
    with pytest.raises(ValueError, match="Duplicate sample ID"):
        mod(pkg, "merge.runner").run_merge(args)


# the unit cases of tests/test_merge.py, for both packages

def U(i):
    return (i, False)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_merge_exact_reference_case(pkg):
    merge_exact = mod(pkg, "merge.exact").merge_exact
    out_gts, out_alleles = merge_exact(
        [[[U(1), U(2)]], [[U(1), U(2)]], [[U(0), U(0)]],
         [[(None, False), (None, False)]], [[U(1), U(2)]]],
        [["CAG", "CAGCAG", "CAGCAGCAG"], ["CAG", "CAGCAGCAG", "CA"],
         ["CAG"], [], ["CAG", "CAGG", "CAGCAG"]])
    assert out_alleles == ["CAG", "CA", "CAGG", "CAGCAG", "CAGCAGCAG"]
    assert out_gts == [[[U(3), U(4)]], [[U(4), U(1)]], [[U(0), U(0)]],
                       [[(None, False), (None, False)]], [[U(2), U(3)]]]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_merge_exact_ref_mismatch(pkg):
    with pytest.raises(ValueError, match="Reference alleles do not match"):
        mod(pkg, "merge.exact").merge_exact([[[U(0)]], [[U(0)]]],
                                            [["CAG"], ["CAA"]])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_merge_exact_phasing_preserved(pkg):
    out_gts, _ = mod(pkg, "merge.exact").merge_exact(
        [[[(0, False), (1, True)]], [[(0, False), (0, True)]]],
        [["C", "CT"], ["C", "CTT"]])
    assert out_gts[0][0] == [(0, False), (1, True)]
    assert mod(pkg, "merge.runner").render_gt(out_gts[0][0]) == "0|1"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_parse_render_gt(pkg):
    runner = mod(pkg, "merge.runner")
    assert runner.parse_gt("0/1") == [(0, False), (1, False)]
    assert runner.parse_gt("0|1") == [(0, False), (1, True)]
    assert runner.parse_gt(".") == [(None, False)]
    assert runner.parse_gt("./.") == [(None, False), (None, False)]
    assert runner.render_gt(runner.parse_gt("1/2")) == "1/2"


# the cases of tests/test_merge_streaming.py, for both packages

HDR = """##fileformat=VCFv4.2
##INFO=<ID=TRID,Number=1,Type=String,Description="x">
##FORMAT=<ID=GT,Number=1,Type=String,Description="x">
##FORMAT=<ID=AL,Number=.,Type=Integer,Description="x">
##FORMAT=<ID=ALLR,Number=.,Type=String,Description="x">
##FORMAT=<ID=AM,Number=.,Type=Float,Description="x">
##contig=<ID=c1,length=1000000>
##contig=<ID=c2,length=1000000>
##trgtVersion=3.0.0-tpu
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1
"""

HDR_LEGACY = HDR.replace("##trgtVersion=3.0.0-tpu\n", "").replace(
    "Type=Float", "Type=Integer")


def rec(contig, pos, al="5,5", am="."):
    return (f"{contig}\t{pos}\t.\tTCAG\tTCAGCAG\t.\t.\tTRID=x\t"
            f"GT:AL:ALLR:AM\t0/1:{al}:5-5,5-5:{am}\n")


def write(tmp_path, body, header=HDR, name="a.vcf"):
    p = tmp_path / name
    p.write_text(header + body)
    return str(p)


def reader(pkg, path):
    return mod(pkg, "merge.vcf_text").VcfTextReader(path)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_streaming_yields_in_order(tmp_path, pkg):
    r = reader(pkg, write(tmp_path, rec("c1", 10) + rec("c1", 20)
                          + rec("c2", 5)))
    assert [x.pos for x in r.records("c1")] == [9, 19]
    assert [x.pos for x in r.records("c2")] == [4]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_missing_contig_between_blocks(tmp_path, pkg):
    r = reader(pkg, write(tmp_path, rec("c1", 10) + rec("c2", 5)))
    assert [x.pos for x in r.records("c1")] == [9]
    assert list(r.records("cX")) == []
    assert [x.pos for x in r.records("c2")] == [4]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unsorted_positions_raise(tmp_path, pkg):
    r = reader(pkg, write(tmp_path, rec("c1", 20) + rec("c1", 10)))
    with pytest.raises(ValueError, match="sort the VCF"):
        list(r.records("c1"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_split_contig_blocks_raise(tmp_path, pkg):
    r = reader(pkg, write(tmp_path, rec("c1", 10) + rec("c2", 5)
                          + rec("c1", 30)))
    assert [x.pos for x in r.records("c1")] == [9]
    with pytest.raises(ValueError, match="out of order"):
        list(r.records("c2"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_scan_mode_skips_to_target(tmp_path, pkg):
    r = reader(pkg, write(tmp_path, rec("c1", 10) + rec("c2", 5)
                          + rec("c2", 7)))
    assert [x.pos for x in r.records("c2", scan=True)] == [4, 6]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pre10_shift_reorders_through_lookahead(tmp_path, pkg):
    body_ = rec("c1", 100, al="0,5") + rec("c1", 100, al="3,3") \
        + rec("c1", 200, al="4,4")
    r = reader(pkg, write(tmp_path, body_, header=HDR_LEGACY))
    assert r.version == (0, 4, 0)
    assert [(x.pos, x.samples[0]["AL"]) for x in r.records("c1")] == \
        [(98, "3,3"), (99, "0,5"), (198, "4,4")]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_contig_subset_skips_unrequested_blocks(tmp_path, pkg):
    r = reader(pkg, write(tmp_path, rec("c1", 10) + rec("c2", 5)
                          + rec("c2", 7)))
    assert [x.pos for x in r.records("c2", upcoming={"c2"})] == [4, 6]


SWAPPED = ("##contig=<ID=c1,length=1000000>\n##contig=<ID=c2,length=1000000>",
           "##contig=<ID=c2,length=1000000>\n##contig=<ID=c1,length=1000000>")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_header_order_mismatch_spills_block(tmp_path, pkg):
    r = reader(pkg, write(tmp_path, rec("c2", 5) + rec("c1", 10)
                          + rec("c1", 20), header=HDR.replace(*SWAPPED)))
    up = {"c1", "c2"}
    assert [x.pos for x in r.records("c1", upcoming=up)] == [9, 19]
    assert [x.pos for x in r.records("c2", upcoming=up)] == [4]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_header_order_mismatch_pre10_spill_shifts(tmp_path, pkg):
    body_ = rec("c2", 100, al="0,5") + rec("c2", 100, al="3,3") \
        + rec("c1", 10)
    r = reader(pkg, write(tmp_path, body_,
                          header=HDR_LEGACY.replace(*SWAPPED)))
    assert r.version == (0, 4, 0)
    up = {"c1", "c2"}
    assert [x.pos for x in r.records("c1", upcoming=up)] == [8]
    assert [(x.pos, x.samples[0]["AL"])
            for x in r.records("c2", upcoming=up)] == \
        [(98, "3,3"), (99, "0,5")]


def merge_args(**kw):
    args = dict(vcf_list=None, output_type="v", contigs=None, skip_n=0,
                process_n=None, print_header=False, force_samples=False,
                force_single=False, quit_on_errors=True, no_version=False,
                genome_path=None)
    args.update(kw)
    return SimpleNamespace(**args)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_merge_contig_subset_end_to_end(tmp_path, pkg):
    out = tmp_path / "merged.vcf"
    mod(pkg, "merge.runner").run_merge(merge_args(
        vcfs=text_vcfs(tmp_path), output=str(out), contigs=["c2"]))
    body_ = [line for line in out.read_text().splitlines()
             if not line.startswith("#")]
    assert len(body_) == 2 and body_[0].startswith("c2\t5\t")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_bcf_input_streams_lazily(tmp_path, pkg):
    hdr_full = HDR.replace(
        '##FORMAT=<ID=AM,Number=.,Type=Float,Description="x">',
        '##FORMAT=<ID=SD,Number=.,Type=Integer,Description="x">\n'
        '##FORMAT=<ID=MC,Number=.,Type=String,Description="x">\n'
        '##FORMAT=<ID=MS,Number=.,Type=String,Description="x">\n'
        '##FORMAT=<ID=AP,Number=.,Type=Float,Description="x">\n'
        '##FORMAT=<ID=AM,Number=.,Type=Float,Description="x">')
    p = write(tmp_path, "".join(rec("c1", 10 + 500 * i) for i in range(200)),
              header=hdr_full, name="in.vcf")
    bcf = str(tmp_path / "in.bcf.gz")
    mod(pkg, "merge.runner").run_merge(merge_args(
        vcfs=[p], output=bcf, output_type="b", force_single=True))
    r = reader(pkg, bcf)
    it = r.records("c1")
    assert next(it).pos == 9
    assert r._bcf_gen is not None
    rest = list(it)
    assert len(rest) == 199 and rest[-1].pos == 9 + 500 * 199


@pytest.mark.parametrize("pkg", PACKAGES)
def test_streaming_is_lazy(tmp_path, pkg):
    r = reader(pkg, write(tmp_path, rec("c1", 10) + rec("c1", 20)))
    it = r.records("c1")
    assert next(it).pos == 9
    assert r._pending is None and r._fh is not None
