"""`validate` through the port's CLI: stdout, stderr and exit code equal
`trgt_tpu`'s, on the bench96 catalog and on catalogs with bad lines."""

import os

import pytest

from trgt_tpu.cli import main as trgt_tpu_main
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.utils.synth import hetero_loci, make_dataset

MAINS = {"trgt_tpu_torch": port_main, "trgt_tpu": trgt_tpu_main}

# lines that fail validation: an unknown contig, a region past the
# contig's end, a start after its end, a missing MOTIFS field, an empty
# motif, too few columns
BAD_LINES = [
    "chrZ\t100\t130\tID=BAD1;MOTIFS=CAG;STRUC=<TR>",
    "chrS\t205000\t999999\tID=BAD2;MOTIFS=CAG;STRUC=<TR>",
    "chrS\t900\t800\tID=BAD3;MOTIFS=CAG;STRUC=<TR>",
    "chrS\t400\t430\tID=BAD4;STRUC=<TR>",
    "chrS\t400\t430\tID=BAD5;MOTIFS=;STRUC=<TR>",
    "chrS\t400\t430",
]


@pytest.fixture(scope="module")
def bench96(tmp_path_factory):
    """The genome and catalog of bench96 (`cached_hetero_dataset(96,
    seed=42)`): the same loci and seed, no reads (the reference is drawn
    before any read)."""
    td = str(tmp_path_factory.mktemp("torch_validate"))
    loci = hetero_loci(96, seed=42)
    for locus in loci:
        locus.depth = 0
    fasta, bed, _bam = make_dataset(td, loci, seed=42)
    return td, fasta, bed


def validate(main, capsys, fasta, bed, *extra):
    rc = main(["validate", "--genome", fasta, "--repeats", bed, *extra])
    out, err = capsys.readouterr()
    return rc, out, err


def catalog(bench96, name, lines):
    path = os.path.join(bench96[0], name)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("flank", [None, "20000"])
@pytest.mark.parametrize("which", ["bench96", "bad_lines", "all_bad"])
def test_validate_output_equal(bench96, capsys, which, flank):
    _td, fasta, bed = bench96
    good = open(bed).read().splitlines()
    if which == "bad_lines":
        bed = catalog(bench96, "bad.bed", good[:40] + BAD_LINES + good[40:])
    elif which == "all_bad":
        bed = catalog(bench96, "all_bad.bed", BAD_LINES)
    extra = ["--flank-len", flank] if flank else []
    got = validate(port_main, capsys, fasta, bed, *extra)
    want = validate(trgt_tpu_main, capsys, fasta, bed, *extra)
    assert got == want
    rc, out, err = got
    assert rc == 0
    if which == "bench96" and not flank:
        assert out.splitlines()[-1] == \
            "Validation successful. Loci pass = 96" and err == ""
    elif which != "bench96":
        assert out.splitlines()[-1].startswith("Validation failed.")
        assert len(err.splitlines()) >= len(BAD_LINES)
