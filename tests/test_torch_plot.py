"""`plot` through the port's CLI: the SVG, PDF and PNG bytes equal
`trgt_tpu`'s for a single-motif and a two-motif locus, both plot types,
motif and methylation colouring, squished or not, on the port's own
`genotype` outputs. Then the segmentation goldens of
tests/test_plot_goldens.py, for both packages."""

import hashlib
import importlib
import os
import re
import sys
import types
import xml.etree.ElementTree as ET
import zlib

import pytest

from trgt_tpu.cli import main as trgt_tpu_main
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset

PACKAGES = ("trgt_tpu_torch", "trgt_tpu")
MAINS = {"trgt_tpu_torch": port_main, "trgt_tpu": trgt_tpu_main}


@pytest.fixture(scope="module")
def genotyped(tmp_path_factory):
    """A single-motif and a two-motif locus, reads with MM/ML tags and 1 %
    substitutions (all-M CIGARs), genotyped by the port."""
    td = str(tmp_path_factory.mktemp("torch_plot"))
    loci = [SynthLocus("ONE", "CAG", 12, (12, 20)),
            SynthLocus("TWO", "CAGCCG", 6, (6, 9), motifs="CAG,CCG")]
    fasta, bed, bam = make_dataset(td, loci, depth=12, meth_prob=180,
                                   error_rate=0.01, seed=3)
    prefix = os.path.join(td, "sample")
    assert port_main(["genotype", "--genome", fasta, "--repeats", bed,
                      "--reads", bam, "--output-prefix", prefix,
                      "--device", "host"]) == 0
    return td, fasta, bed, prefix


def plot(main, genotyped, out, tr_id, *extra):
    _td, fasta, bed, prefix = genotyped
    return main(["plot", "--genome", fasta, "--repeats", bed,
                 "--vcf", prefix + ".vcf.gz",
                 "--spanning-reads", prefix + ".spanning.bam",
                 "--repeat-id", tr_id, "--image", out, *extra])


def check_image(data: bytes, ext: str):
    if ext == "svg":
        assert data.startswith(b'<?xml version="1.0"?>')
        ET.fromstring(data)
    elif ext == "pdf":
        assert data.startswith(b"%PDF-1.4")
        assert data.rstrip().endswith(b"%%EOF")
        m = re.search(rb"stream\n(.*?)\nendstream", data, re.S)
        assert "Tj" in zlib.decompress(m.group(1)).decode("latin-1")
    else:
        assert data[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("ext", ["svg", "pdf", "png"])
@pytest.mark.parametrize("squished", [False, True])
@pytest.mark.parametrize("show", ["motifs", "meth"])
@pytest.mark.parametrize("plot_type", ["allele", "waterfall"])
@pytest.mark.parametrize("tr_id", ["ONE", "TWO"])
def test_plot_bytes_equal(genotyped, tmp_path, tr_id, plot_type, show,
                          squished, ext):
    extra = ["--plot-type", plot_type, "--show", show]
    if squished:
        extra += ["--squished", "--max-allele-reads", "5"]
    images = {}
    for pkg in PACKAGES:
        out = str(tmp_path / f"{pkg}.{ext}")
        assert plot(MAINS[pkg], genotyped, out, tr_id, *extra) == 0
        images[pkg] = open(out, "rb").read()
    check_image(images["trgt_tpu_torch"], ext)
    assert images["trgt_tpu_torch"] == images["trgt_tpu"]


def test_plot_colours(genotyped, tmp_path):
    """The motif legend (CAG blue, CCG beside it) and the teal flanks are
    drawn; the methylation view colours by the reads' ML values."""
    out = str(tmp_path / "two.svg")
    assert plot(port_main, genotyped, out, "TWO") == 0
    svg = open(out).read()
    assert "#1383C6" in svg and "#009CA2" in svg
    meth = str(tmp_path / "meth.svg")
    assert plot(port_main, genotyped, meth, "ONE", "--show", "meth") == 0
    assert open(meth).read() != open(out).read()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_png_without_pillow_fails(genotyped, tmp_path, monkeypatch, pkg):
    """Where cairosvg does not import, PNG goes through Pillow: without it
    too, `plot` fails and writes no image, in both packages."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = str(tmp_path / "x.png")
    assert plot(MAINS[pkg], genotyped, out, "ONE") == 1
    assert not os.path.exists(out)


@pytest.mark.parametrize("plot_type", ["allele", "waterfall"])
@pytest.mark.parametrize("tr_id", ["ONE", "TWO"])
def test_png_through_cairosvg_where_it_imports(genotyped, tmp_path,
                                               monkeypatch, tr_id,
                                               plot_type):
    """With a `cairosvg` module importable (a stub here), both packages
    hand it the plot's SVG and write what it renders, not Pillow's
    raster."""
    calls = []

    def svg2png(bytestring, write_to):
        calls.append(bytestring)
        with open(write_to, "wb") as fh:
            fh.write(b"\x89PNG\r\n\x1a\n"
                     + hashlib.sha256(bytestring).digest())

    stub = types.ModuleType("cairosvg")
    stub.svg2png = svg2png
    monkeypatch.setitem(sys.modules, "cairosvg", stub)
    extra = ["--plot-type", plot_type]
    images = {}
    for pkg in PACKAGES:
        out = str(tmp_path / f"{pkg}.png")
        assert plot(MAINS[pkg], genotyped, out, tr_id, *extra) == 0
        images[pkg] = open(out, "rb").read()
    svg = str(tmp_path / "plot.svg")
    assert plot(port_main, genotyped, svg, tr_id, *extra) == 0
    assert calls == [open(svg, "rb").read()] * 2
    assert images["trgt_tpu_torch"] == images["trgt_tpu"] == \
        b"\x89PNG\r\n\x1a\n" + hashlib.sha256(calls[0]).digest()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_plot_unknown_repeat_id_fails(genotyped, tmp_path, pkg):
    assert plot(MAINS[pkg], genotyped, str(tmp_path / "x.svg"),
                "NOPE") == 1


# the cases of tests/test_plot_goldens.py (hand-derived segmentations),
# for both packages

def flat(align):
    return [(s.width, s.op, s.seg_type) for s in align]


def plot_align(pkg):
    return importlib.import_module(f"{pkg}.plot.align")


GOLDENS = [
    # perfect repeat
    ([b"CAG"], "CAGCAGCAG", [(9, "match", ("tr", 0))]),
    # motifs <= 6 bp: imperfect copies become the skip block, Tr(1)
    ([b"CAG"], "CAGCTGCAG", [(3, "match", ("tr", 0)),
                             (3, "match", ("tr", 1)),
                             (3, "match", ("tr", 0))]),
    ([b"CAG"], "CAGCAAGCAG", [(3, "match", ("tr", 0)),
                              (4, "match", ("tr", 1)),
                              (3, "match", ("tr", 0))]),
    ([b"CAG"], "CAGCGCAG", [(3, "match", ("tr", 0)),
                            (2, "match", ("tr", 1)),
                            (3, "match", ("tr", 0))]),
    # two motifs
    ([b"CAG", b"CCG"], "CAGCAGCCGCCG", [(6, "match", ("tr", 0)),
                                        (6, "match", ("tr", 1))]),
    # a non-repeat run
    ([b"CAG"], "CAGTTTTTTTTCAG", [(3, "match", ("tr", 0)),
                                  (8, "match", ("tr", 1)),
                                  (3, "match", ("tr", 0))]),
    # motifs > 6 bp keep imperfect copies: subst, query insertion as a
    # 1-wide del, query deletion as a 0-wide ins
    ([b"CAGCAGC"], "CAGCAGC" "CAGTAGC" "CAGCAGC",
     [(10, "match", ("tr", 0)), (1, "subst", ("tr", 0)),
      (10, "match", ("tr", 0))]),
    ([b"CAGCAGC"], "CAGCAGC" "CAGCAAGC" "CAGCAGC",
     [(11, "match", ("tr", 0)), (1, "del", ("tr", 0)),
      (10, "match", ("tr", 0))]),
    ([b"CAGCAGC"], "CAGCAGC" "CAGCGC" "CAGCAGC",
     [(11, "match", ("tr", 0)), (0, "ins", ("tr", 0)),
      (9, "match", ("tr", 0))]),
]


@pytest.mark.parametrize("case", range(len(GOLDENS)))
@pytest.mark.parametrize("pkg", PACKAGES)
def test_align_motifs_golden(pkg, case):
    motifs, seq, want = GOLDENS[case]
    assert flat(plot_align(pkg).align_motifs(motifs, seq)) == want


@pytest.mark.parametrize("pkg", PACKAGES)
def test_align_consensus_wraps_flanks(pkg):
    class L:
        left_flank = "TTTT"
        right_flank = "GGG"
        motifs = ["CAG"]

    cons = "TTTT" + "CAGCAGCAG" + "GGG"
    assert flat(plot_align(pkg).align_consensus(L, cons)) == [
        (4, "match", ("lf",)), (9, "match", ("tr", 0)),
        (3, "match", ("rf",))]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_convert_read_align_projects_deletion(pkg):
    align = plot_align(pkg)
    convert = importlib.import_module(f"{pkg}.plot.plots")._convert_read_align
    cons, read = "CAGCAGCAG", "CAGCAGAG"
    ca = align.align_motifs([b"CAG"], cons)
    wfa = align.e2e_align(cons.encode(), read.encode())
    assert "".join(wfa.operations) == "MMMMMMDMM"
    assert flat(convert(ca, wfa)) == [
        (6, "match", ("tr", 0)), (1, "del", ("tr", 0)),
        (2, "match", ("tr", 0))]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_convert_read_align_projects_insertion(pkg):
    align = plot_align(pkg)
    convert = importlib.import_module(f"{pkg}.plot.plots")._convert_read_align
    cons, read = "CAGCAGCAG", "CAGCAGTCAG"
    ca = align.align_motifs([b"CAG"], cons)
    wfa = align.e2e_align(cons.encode(), read.encode())
    conv = flat(convert(ca, wfa))
    assert "".join(wfa.operations).count("I") == 1
    assert sum(1 for _w, op, _st in conv if op == "ins") == 1
    assert sum(w for w, op, _st in conv
               if op in ("match", "subst", "del")) == len(cons)
