"""Dry run of the production `genotype` over a device mesh (counterpart
of `trgt_tpu/engine/sharding.py`).

`dryrun(n, device)` builds a synthetic six-locus dataset (FASTA + BED +
BAM, utils/synth.py), runs the real `genotype` command twice, once with
every kernel batch cut over an n-entry mesh of `device` (the device
repeated, so one card, or the CPU, holds the split: mesh.py) and once on
the host twins (`--device host`), and asserts that the VCF bodies are
byte-identical: extraction, the span kernel, the genotypers' kernels, the
Viterbi kernel and the VCF writer all ran through the split and the
reassembly.
"""

import os
import tempfile

from .. import mesh


def _vcf_body(path: str) -> bytes:
    from ..io.bgzf import BgzfReader
    data = BgzfReader(path).read_all()
    return b"\n".join(line for line in data.splitlines()
                      if not line.startswith(b"##"))


def _run(fasta, bed, bam, prefix, device):
    from ..cli import main as cli_main
    rc = cli_main(["genotype", "--genome", fasta, "--repeats", bed,
                   "--reads", bam, "--output-prefix", prefix,
                   "--device", device])
    if rc != 0:
        raise RuntimeError(f"genotype --device {device} failed ({rc})")
    return _vcf_body(prefix + ".vcf.gz")


def dryrun(n_devices: int, device: str = "cuda") -> None:
    """One production genotyping pass over an n-entry mesh of `device`
    (`cuda` or `cpu`), held byte for byte against the host path."""
    import torch
    from ..utils.synth import SynthLocus, make_dataset

    loci = [
        SynthLocus("HOM", "CAG", 15, (15, 15)),
        SynthLocus("HET", "CAG", 10, (10, 20)),
        SynthLocus("EXP", "GGC", 8, (8, 40)),
        SynthLocus("REF", "AT", 12, (12, 12)),
        SynthLocus("A10", "A", 10, (10, 14)),
        SynthLocus("MIX", "CAG", 12, (12, 16), motifs="CAG,CAA"),
    ]
    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    prev = os.environ.pop("TRGT_TPU_MESH", None)
    try:
        with tempfile.TemporaryDirectory() as td:
            fasta, bed, bam = make_dataset(td, loci, depth=10)
            mesh.set_mesh([dev] * n_devices)
            meshed = _run(fasta, bed, bam, f"{td}/mesh", device)
            active = mesh.current_mesh()
            if active is None or len(active) != n_devices:
                raise AssertionError("the mesh was not active during the "
                                     "device run")
            mesh.disable_mesh()
            host = _run(fasta, bed, bam, f"{td}/host", "host")
            if meshed != host:
                raise AssertionError("the mesh-split device pipeline "
                                     "diverged from the host path")
    finally:
        mesh.disable_mesh()
        if prev is not None:
            os.environ["TRGT_TPU_MESH"] = prev
