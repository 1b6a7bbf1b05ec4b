"""`genotype -t N` of the port: N worker processes (engine/worker.py)
take catalog chunks as they ask and ship rendered records, which the
parent merges in catalog order. Every output file is byte-identical to
`-t 1`'s, under `--device host` and `--device cpu`, and the records equal
`trgt_tpu -t N --device host`'s (cases of tests/test_multiproc.py on
synthetic data)."""

import os
import subprocess
import sys
import time

import pytest
import torch

from trgt_tpu.cli import main as trgt_tpu_main
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.engine import runner as port_runner
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset

from test_torch_genotype import records

OUTPUTS = (".vcf.gz", ".spanning.bam")


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    # the workers inherit it: several test processes share the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # a four-locus catalog starts the pool
    monkeypatch.setattr(port_runner, "POOL_MIN_LOCI", 0)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Four loci (fewer than five workers), reads with 1 % errors so that
    spans miss the exact path, and a bad catalog line."""
    td = str(tmp_path_factory.mktemp("torch_multiproc"))
    loci = [SynthLocus(f"T{i}", "CAG", 10 + i, (10 + i, 14 + 2 * i))
            for i in range(4)]
    fasta, bed, bam = make_dataset(td, loci, depth=12, error_rate=0.01)
    with open(bed, "a") as fh:
        fh.write("chrS\t10\t5\tID=BAD;MOTIFS=CAG;STRUC=<TR>\n")
    return td, fasta, bed, bam


_runs = {}


def run(main, dataset, name, *extra):
    """Output file bytes of one genotype run, made once per module."""
    if name not in _runs:
        td, fasta, bed, bam = dataset
        prefix = os.path.join(td, name)
        rc = main(["genotype", "--genome", fasta, "--repeats", bed,
                   "--reads", bam, "--output-prefix", prefix, *extra])
        assert rc == 0
        _runs[name] = {ext: open(prefix + ext, "rb").read()
                       for ext in OUTPUTS}
        _runs[name]["prefix"] = prefix
    return _runs[name]


@pytest.mark.parametrize("threads", [2, 3, 5])
@pytest.mark.parametrize("device", ["host", "cpu"])
def test_outputs_byte_identical_to_t1(dataset, device, threads):
    base = run(port_main, dataset, f"{device}_t1", "--device", device)
    multi = run(port_main, dataset, f"{device}_t{threads}", "--device",
                device, "-t", str(threads))
    # sys.argv (the ##trgtCommand / @PG source) is pytest's own in both
    # runs, so the whole files compare
    for ext in OUTPUTS:
        assert multi[ext] == base[ext], f"{ext} differs at -t {threads}"


@pytest.mark.parametrize("threads", [2, 3, 5])
def test_records_equal_trgt_tpu_pool(dataset, threads):
    want = run(trgt_tpu_main, dataset, f"ref_t{threads}", "--device",
               "host", "-t", str(threads))
    got = run(port_main, dataset, f"host_t{threads}", "--device", "host",
              "-t", str(threads))
    vcf, bam = records(got["prefix"])
    assert len(vcf) == 5 and len(bam) > 0       # header line + 4 loci
    assert (vcf, bam) == records(want["prefix"])


def test_procs_0_keeps_the_thread_path(dataset, monkeypatch):
    base = run(port_main, dataset, "cpu_t1", "--device", "cpu")
    spawned = []
    monkeypatch.setattr(port_runner.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    monkeypatch.setenv("TRGT_TPU_PROCS", "0")
    threads = run(port_main, dataset, "cpu_t3_threads", "--device", "cpu",
                  "-t", "3")
    assert spawned == []
    for ext in OUTPUTS:
        assert threads[ext] == base[ext]


@pytest.mark.parametrize("threads,shards,procs,pool", [
    ("2", None, None, True),     # 5 catalog lines, 4 needed
    ("3", None, None, False),    # 6 needed
    ("2", "2", None, False),     # a shard of the catalog: 8 needed
    ("2", None, "0", False),     # TRGT_TPU_PROCS=0
    ("1", None, None, False)])
def test_pool_needs_loci_for_every_worker(dataset, monkeypatch, tmp_path,
                                          threads, shards, procs, pool):
    monkeypatch.setattr(port_runner, "POOL_MIN_LOCI", 2)
    if procs is not None:
        monkeypatch.setenv("TRGT_TPU_PROCS", procs)
    extra = ["-t", threads]
    if shards:
        extra += ["--shard-index", "0", "--shard-count", shards]
    assert port_runner.use_pool(port_args(dataset, tmp_path, *extra)) == pool


def test_small_catalog_keeps_the_thread_path(dataset, monkeypatch):
    base = run(port_main, dataset, "cpu_t1", "--device", "cpu")
    spawned = []
    monkeypatch.setattr(port_runner.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    monkeypatch.setattr(port_runner, "POOL_MIN_LOCI", 64)
    threads = run(port_main, dataset, "cpu_t2_small", "--device", "cpu",
                  "-t", "2")
    assert spawned == []
    for ext in OUTPUTS:
        assert threads[ext] == base[ext]


def test_failing_worker_takes_the_others_down(dataset, monkeypatch,
                                              tmp_path):
    """Worker 1 exits at once; the others would sleep for a minute. The
    parent fails within seconds, and no worker outlives it."""
    spawned = []
    real_popen = subprocess.Popen

    def argv(spec):
        if spec["worker_index"] == 1:
            return [sys.executable, "-c", "import sys; sys.exit(3)"]
        return [sys.executable, "-c", "import time; time.sleep(60)"]

    def popen(*a, **k):
        spawned.append(real_popen(*a, **k))
        return spawned[-1]

    monkeypatch.setattr(port_runner, "_worker_argv", argv)
    monkeypatch.setattr(port_runner.subprocess, "Popen", popen)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="worker 1 exited"):
        port_runner.run_genotype(port_args(dataset, tmp_path, "-t", "3"))
    assert time.perf_counter() - t0 < 30
    assert len(spawned) == 3
    assert all(p.poll() is not None for p in spawned)
    assert all(p.stdout.closed and p.stdin.closed for p in spawned)


def port_args(dataset, tmp_path, *extra):
    from trgt_tpu_torch.cli import apply_genotype_preset, build_parser
    td, fasta, bed, bam = dataset
    args = build_parser().parse_args(
        ["genotype", "--genome", fasta, "--repeats", bed, "--reads", bam,
         "--output-prefix", str(tmp_path / "out"), "--device", "host",
         *extra])
    apply_genotype_preset(args)
    return args


def test_cuda_pool_without_a_card_fails_at_once(dataset, monkeypatch,
                                                tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(port_runner.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    td, fasta, bed, bam = dataset
    prefix = str(tmp_path / "nocard")
    rc = port_main(["genotype", "--genome", fasta, "--repeats", bed,
                    "--reads", bam, "--output-prefix", prefix, "-t", "2"])
    assert rc == 1
    assert spawned == []
    assert not os.path.exists(prefix + ".vcf.gz")


def test_cuda_pool_without_a_card_stops_its_workers(dataset, monkeypatch,
                                                   tmp_path):
    """With the kernels built, the workers are spawned before the parent
    checks the card: without one, the parent kills them and fails."""
    from trgt_tpu_torch.kernels import _build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "library_path", lambda: __file__)
    spawned = []
    real_popen = subprocess.Popen

    def popen(*a, **k):
        spawned.append(real_popen(
            [sys.executable, "-c", "import time; time.sleep(60)"], **k))
        return spawned[-1]

    monkeypatch.setattr(port_runner.subprocess, "Popen", popen)
    td, fasta, bed, bam = dataset
    prefix = str(tmp_path / "nocard")
    t0 = time.perf_counter()
    rc = port_main(["genotype", "--genome", fasta, "--repeats", bed,
                    "--reads", bam, "--output-prefix", prefix, "-t", "2"])
    assert rc == 1
    assert time.perf_counter() - t0 < 30
    assert len(spawned) == 2
    assert all(p.poll() is not None for p in spawned)
    assert all(p.stdout.closed and p.stdin.closed for p in spawned)
    assert not os.path.exists(prefix + ".vcf.gz")


@pytest.mark.cuda
def test_cuda_pool_matches_t1(dataset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = run(port_main, dataset, "cuda_t1", "--device", "cuda")
    multi = run(port_main, dataset, "cuda_t2", "--device", "cuda", "-t", "2")
    for ext in OUTPUTS:
        assert multi[ext] == base[ext]
