"""The port never imports JAX. tests/conftest.py imports JAX into every
test process, so the run is checked in a subprocess."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
from trgt_tpu.utils.synth import SynthLocus, make_dataset
from trgt_tpu_torch.cli import main
td = sys.argv[1]
fasta, bed, bam = make_dataset(td, [SynthLocus("HET", "CAG", 10, (10, 20)),
                                    SynthLocus("ATX", "AT", 12, (12, 15))],
                               depth=12)
rc = main(["genotype", "--genome", fasta, "--repeats", bed, "--reads", bam,
           "--output-prefix", td + "/out", "--device", sys.argv[2]])
print("rc", rc, "jax", "jax" in sys.modules)
"""


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_genotype_run_imports_no_jax(tmp_path, device):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path),
                           device], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-4:] == ["rc", "0", "jax", "False"]
    assert (tmp_path / "out.vcf.gz").exists()


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
    jax_only = {"trgt_tpu.kernels.semiglobal", "trgt_tpu.kernels.viterbi",
                "trgt_tpu.kernels.semiglobal_pallas",
                "trgt_tpu.kernels.editdist",
                "trgt_tpu.kernels.editdist_pallas",
                "trgt_tpu.kernels.e2e_device", "trgt_tpu.mesh",
                "trgt_tpu.jax_setup", "trgt_tpu.engine.sharding",
                "trgt_tpu.engine.worker"}
    for path in _port_sources():
        for mod in _imported_modules(path):
            assert mod.split(".")[0] != "jax", (path, mod)
            assert mod not in jax_only, (path, mod)
