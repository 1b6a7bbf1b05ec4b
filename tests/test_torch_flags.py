"""The non-default flags of `genotype` in the port, held against the
reference: depth above `--max-depth` (the reservoir walk of the read
extraction at 3 x max-depth, and the downsample of the spanning reads in
`BatchPipeline._finish_spans`), `--aln-scoring` under both presets,
`--min-flank-id-frac`, `--min-read-quality` on reads of mixed quality and
`--output-flank-len`. For every flag set, the port's `--device cpu` (the
kernels' plain versions) and `--device host` (the host twins) write the
VCF and spanning-BAM records of `trgt_tpu genotype --device host`. Then
`-t 2` through the port's worker pool from a CRAM written by its own
`io/cram_write.py`: the records of the BAM run."""

import logging
import os
import sys

import pytest
import torch

from trgt_tpu.cli import main as trgt_tpu_main
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.engine import pipeline as port_pipeline
from trgt_tpu_torch.engine import runner as port_runner
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset

from test_torch_cram import bam_to_cram
from test_torch_genotype import records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the flag sets, the read-quality rewrites and the warnings of chip_smoke's
# flags phase, which runs them under --device cuda
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

# depths 30-60, several motifs (one locus with a second, decoy motif), het
# loci, and read errors of 4 and 8 % on two loci: their spans go through
# the flank alignment, whose scoring and identity threshold then change
# records. 1 kb between loci keeps every read off its neighbours' regions,
# so a locus's reads are its depth: over 3 x 2 (the reservoir at
# --max-depth 2) and at most 3 x 20 (no reservoir at --max-depth 20, where
# only the downsample of the spanning reads runs)
LOCI = [SynthLocus("F1", "CAG", 12, (12, 16), depth=40),
        SynthLocus("F2", "AT", 15, (15, 15), depth=30),
        SynthLocus("F3", "GGCC", 8, (6, 11), depth=60, error_rate=0.04),
        SynthLocus("F4", "AAAG", 9, (9, 12), motifs="AAAG,AAGG", depth=50,
                   error_rate=0.08),
        SynthLocus("F5", "T", 20, (20, 24), depth=36)]
LOCUS_GAP = 1000

RESERVOIR, QUALITY_FILTERED = cs.FLAG_WARNINGS


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("torch_flags"))
    fasta, bed, _bam = make_dataset(td, LOCI, flank=LOCUS_GAP, seed=11)
    cs.rq_reads(td, cs.MIXED_RQ_READS, cs.MIXED_RQ)
    cs.low_quality_reads(td)
    bam_to_cram(os.path.join(td, "reads.bam"), fasta,
                os.path.join(td, "reads.cram"))
    return td, fasta, bed


_runs = {}


def genotype(main, dataset, name, reads, extra, caplog):
    """(records, the warnings the run logged), made once per module."""
    if name not in _runs:
        td, fasta, bed = dataset
        prefix = os.path.join(td, name)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="trgt"):
            rc = main(["genotype", "--genome", fasta, "--repeats", bed,
                       "--reads", os.path.join(td, reads), "--output-prefix",
                       prefix, *extra])
        assert rc == 0
        _runs[name] = (records(prefix),
                       [r.getMessage() for r in caplog.records
                        if r.levelno == logging.WARNING])
    return _runs[name]


@pytest.fixture
def downsampled(monkeypatch):
    """The reads lists `_finish_spans` downsampled, by length before."""
    seen = []
    orig = port_pipeline.uniform_downsample

    def spy(items, n):
        seen.append(len(items))
        return orig(items, n)

    monkeypatch.setattr(port_pipeline, "uniform_downsample", spy)
    return seen


def logged(warnings, text):
    return sum(text in w for w in warnings)


@pytest.mark.parametrize("port_device", ["cpu", "host"])
@pytest.mark.parametrize("flag_set", list(cs.FLAG_SETS))
def test_flags_match_trgt_tpu_host(dataset, flag_set, port_device, caplog,
                                   downsampled):
    preset, reads, flags = cs.FLAG_SETS[flag_set]
    extra = ["--preset", preset, *flags]
    want, ref_warnings = genotype(trgt_tpu_main, dataset, f"ref_{flag_set}",
                                  reads, extra + ["--device", "host"], caplog)
    got, warnings = genotype(port_main, dataset,
                             f"port_{flag_set}_{port_device}", reads,
                             extra + ["--device", port_device], caplog)
    assert len(want[0]) == len(LOCI) + 1 and len(want[1]) > 0
    assert got == want
    # the flag reached the code: the records differ from the preset's own
    default, _ = genotype(port_main, dataset,
                          f"port_default_{preset}_{reads}_{port_device}",
                          reads, ["--preset", preset, "--device",
                                  port_device], caplog)
    assert got != default
    # the port took the path the flag asks for, as the reference did
    if flag_set == "max_depth_2":
        assert logged(warnings, RESERVOIR) == len(LOCI)
        for line in got[0][1:]:
            fmt, sample = line.split("\t")[8:10]
            sd = dict(zip(fmt.split(":"), sample.split(":")))["SD"]
            assert sum(int(x) for x in sd.split(",")) <= 2
    elif flag_set == "max_depth_20":
        assert logged(warnings, RESERVOIR) == 0
        assert downsampled and all(n > 20 for n in downsampled)
        assert len(downsampled) == len(LOCI)
    elif flag_set == "min_read_quality":
        assert logged(warnings, QUALITY_FILTERED) == len(LOCI)
    else:
        assert logged(warnings, RESERVOIR) == 0
    assert [logged(ref_warnings, t) for t in (RESERVOIR, QUALITY_FILTERED)] \
        == [logged(warnings, t) for t in (RESERVOIR, QUALITY_FILTERED)]


@pytest.mark.parametrize("port_device", ["cpu", "host"])
def test_cram_pool_matches_bam_run(dataset, port_device, caplog,
                                   monkeypatch):
    """`-t 2` from the port's CRAM through the worker pool (two worker
    processes, each opening its own CRAM reader): the VCF records of `-t 1`
    from the BAM, and the records of `-t 1` from the same CRAM and of
    `trgt_tpu --device host` from it (the spanning BAM from a CRAM carries
    M where the BAM's CIGARs carry = and X)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(port_runner, "POOL_MIN_LOCI", 0)
    spawned = []
    real_popen = port_runner.subprocess.Popen

    def popen(*a, **k):
        spawned.append(a)
        return real_popen(*a, **k)

    monkeypatch.setattr(port_runner.subprocess, "Popen", popen)
    device = ["--device", port_device]
    pool, _ = genotype(port_main, dataset, f"port_cram_t2_{port_device}",
                       "reads.cram", device + ["-t", "2"], caplog)
    assert len(spawned) == 2
    cram, _ = genotype(port_main, dataset, f"port_cram_t1_{port_device}",
                       "reads.cram", device, caplog)
    bam, _ = genotype(port_main, dataset, f"port_bam_t1_{port_device}",
                      "reads.bam", device, caplog)
    ref, _ = genotype(trgt_tpu_main, dataset, "ref_cram", "reads.cram",
                      ["--device", "host"], caplog)
    assert len(pool[0]) == len(LOCI) + 1 and len(pool[1]) > 0
    assert pool[0] == bam[0]
    assert pool == cram == ref
