"""The port never imports JAX nor anything of the JAX package `trgt_tpu`.
tests/conftest.py imports JAX into every test process, so the run is
checked in a subprocess."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset
from trgt_tpu_torch.cli import main
td = sys.argv[1]
fasta, bed, bam = make_dataset(td, [SynthLocus("HET", "CAG", 10, (10, 20)),
                                    SynthLocus("ATX", "AT", 12, (12, 15))],
                               depth=12)
rc = main(["genotype", "--genome", fasta, "--repeats", bed, "--reads", bam,
           "--output-prefix", td + "/out", "--device", sys.argv[2],
           *sys.argv[3:]])
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "trgt_tpu"))
print("rc", rc, "foreign", foreign)
"""


def _run_child(tmp_path, device, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path),
                           device, *extra], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "rc 0 foreign []"
    assert (tmp_path / "out.vcf.gz").exists()


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_genotype_run_imports_no_jax(tmp_path, device):
    _run_child(tmp_path, device)


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_targeted_run_imports_no_jax_and_no_trgt_tpu(tmp_path, device):
    _run_child(tmp_path, device, "--preset", "targeted")


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


def test_no_source_imports_jax():
    """No module of trgt_tpu_torch/**.py nor chip_smoke.py imports `jax`,
    `trgt_tpu` or `trgt_tpu.*`, not even lazily inside a function."""
    n_files = 0
    for path in _port_sources():
        n_files += 1
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "trgt_tpu"), \
                (path, mod)
    assert n_files > 40
