"""The port never imports JAX nor anything of the JAX package `trgt_tpu`.
tests/conftest.py imports JAX into every test process, so each run is
checked in a subprocess: `genotype`, the parent of a `genotype -t 2` run,
and `merge`, `plot` and `validate` on a genotype run's outputs (these
three load no torch either)."""

import ast
import os
import subprocess
import sys

import pytest

from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
from trgt_tpu_torch.cli import main
from trgt_tpu_torch.engine import runner
runner.POOL_MIN_LOCI = 0    # a two-locus catalog starts the pool
rc = main(sys.argv[1:])
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "trgt_tpu"))
print("rc", rc, "foreign", foreign, "torch", "torch" in sys.modules)
"""


def _dataset(tmp_path):
    return make_dataset(str(tmp_path),
                        [SynthLocus("HET", "CAG", 10, (10, 20)),
                         SynthLocus("ATX", "AT", 12, (12, 15))], depth=12)


def _run_child(argv, torch_loaded):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD, *argv], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == \
        f"rc 0 foreign [] torch {torch_loaded}"
    return proc


def _run_genotype_child(tmp_path, device, *extra, torch_loaded=True):
    fasta, bed, bam = _dataset(tmp_path)
    _run_child(["genotype", "--genome", fasta, "--repeats", bed, "--reads",
                bam, "--output-prefix", str(tmp_path / "out"), "--device",
                device, *extra], torch_loaded)
    assert (tmp_path / "out.vcf.gz").exists()


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_genotype_run_imports_no_jax(tmp_path, device):
    _run_genotype_child(tmp_path, device)


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_targeted_run_imports_no_jax_and_no_trgt_tpu(tmp_path, device):
    _run_genotype_child(tmp_path, device, "--preset", "targeted")


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_pool_parent_imports_no_jax_and_no_torch(tmp_path, device,
                                                 monkeypatch):
    """`-t 2`: the parent only merges its workers' records (they import
    torch; the parent checks `--device` without it on cpu and host)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _run_genotype_child(tmp_path, device, "-t", "2", torch_loaded=False)


@pytest.mark.parametrize("command", ["merge", "plot", "validate"])
def test_host_command_imports_no_jax_and_no_torch(tmp_path, command):
    fasta, bed, bam = _dataset(tmp_path)
    prefix = str(tmp_path / "out")
    assert port_main(["genotype", "--genome", fasta, "--repeats", bed,
                      "--reads", bam, "--output-prefix", prefix,
                      "--device", "host"]) == 0
    out = str(tmp_path / {"merge": "merged.bcf", "plot": "het.svg",
                          "validate": "unused"}[command])
    argv = {
        "merge": ["merge", "--vcf", prefix + ".vcf.gz", "--force-single",
                  "-o", out, "-O", "b"],
        "plot": ["plot", "--genome", fasta, "--repeats", bed, "--vcf",
                 prefix + ".vcf.gz", "--spanning-reads",
                 prefix + ".spanning.bam", "--repeat-id", "HET", "--image",
                 out],
        "validate": ["validate", "--genome", fasta, "--repeats", bed],
    }[command]
    proc = _run_child(argv, False)
    if command == "validate":
        assert "Validation successful. Loci pass = 2" in proc.stdout
    else:
        assert os.path.getsize(out) > 0


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_sources():
    root = os.path.join(REPO, "trgt_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_profile.py")
    yield os.path.join(REPO, "bench_torch.py")


def test_no_source_imports_jax():
    """No module of trgt_tpu_torch/**.py, chip_smoke.py, chip_profile.py
    nor bench_torch.py imports `jax`,
    `trgt_tpu` or `trgt_tpu.*`, not even lazily inside a function."""
    n_files = 0
    for path in _port_sources():
        n_files += 1
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "trgt_tpu"), \
                (path, mod)
    assert n_files > 40
