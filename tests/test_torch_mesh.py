"""The port's device mesh (mesh.py): the four batch entry points cut
their problems over a list of devices and give back exactly what they
give without the mesh (the cases of tests/test_sharding.py:39-115, plus
e2e), the production `genotype` over the mesh equals the host run
(`engine/sharding.py dryrun`), and the TRGT_TPU_MESH overrides. One CPU
or one card holds the split with a repeated device."""

import random

import pytest
import torch

from trgt_tpu_torch import mesh
from trgt_tpu_torch.hmm import build_hmm
from trgt_tpu_torch.kernels import e2e, telemetry
from trgt_tpu_torch.kernels.editdist import edit_distances_batch
from trgt_tpu_torch.kernels.semiglobal import flank_align_batch_multi
from trgt_tpu_torch.kernels.viterbi import viterbi_batch_multi

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _mesh_cleanup(monkeypatch):
    monkeypatch.delenv("TRGT_TPU_MESH", raising=False)
    mesh.disable_mesh()
    yield
    mesh.disable_mesh()


def _random_dna(rng, lo, hi):
    return bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo, hi)))


def _mutate(rng, seq, n):
    b = bytearray(seq)
    for _ in range(n):
        b[rng.randrange(len(b))] = rng.choice(b"ACGT")
    return bytes(b)


def entry_point_cases():
    """(name, fn(device)) of each batch entry point on seeded inputs."""
    rng = random.Random(5)
    pattern = _random_dna(rng, 40, 40)
    texts = [_random_dna(rng, 30, 90) for _ in range(21)]
    texts += [_random_dna(rng, 10, 20) + _mutate(rng, pattern, 3)
              + _random_dna(rng, 5, 300) for _ in range(6)]
    hmms = [build_hmm([b"CAG"]), build_hmm([b"CAG", b"A"]),
            build_hmm([b"AT"])]
    queries = ["CAG" * rng.randint(3, 12) for _ in range(9)]
    pairs = [(_random_dna(rng, 10, 30), _random_dna(rng, 10, 30))
             for _ in range(17)]
    # full-matrix and band problems, one of each twice, and an empty side
    near = _random_dna(rng, 300, 300)
    problems = [(_random_dna(rng, 5, 60), _random_dna(rng, 5, 60))
                for _ in range(9)]
    problems += [(near, _mutate(rng, near, 6)), (near, near[:250]),
                 (near[:200], _random_dna(rng, 240, 240)), (b"", near),
                 (near, _mutate(rng, near, 6))]
    return [
        ("flank", lambda dev: flank_align_batch_multi(
            [pattern] * len(texts), texts, 2, 5, 1, dev)),
        ("viterbi", lambda dev: viterbi_batch_multi(
            [hmms[i % 3] for i in range(9)], queries, dev)),
        ("editdist", lambda dev: edit_distances_batch(pairs, dev)),
        ("e2e", lambda dev: e2e.e2e_align_batch(problems, 2, 5, 1, dev)),
    ]


def calls(kernel):
    snap = telemetry.totals(telemetry.snapshot())
    return snap.get(kernel, {}).get("calls", 0)


@pytest.mark.parametrize("case", range(4))
def test_entry_points_under_an_eight_cpu_mesh(case):
    name, fn = entry_point_cases()[case]
    e2e.routed.clear()
    plain = fn(CPU)
    plain_routed = dict(e2e.routed)
    mesh.set_mesh([CPU] * 8)
    assert mesh.batch_multiple() == 8
    e2e.routed.clear()
    before = calls(name)
    sharded = fn(CPU)
    assert sharded == plain
    # every one of the eight shards made its own calls
    assert calls(name) - before >= 8
    if name == "e2e":
        assert dict(e2e.routed) == plain_routed
        assert plain_routed["band_problems"] > 0


@pytest.mark.parametrize("case", range(4))
def test_telemetry_counts_by_shard(case):
    """Each shard's thread counts under its own index, and the shards'
    counts add up to the whole."""
    name, fn = entry_point_cases()[case]
    mesh.set_mesh([CPU] * 8)
    telemetry.clear()
    fn(CPU)
    whole = telemetry.totals(telemetry.snapshot())[name]
    shards = {k: telemetry.totals(snap).get(name, {})
              for k, snap in telemetry.by_shard().items()}
    assert sorted(shards) == list(range(8))
    assert all(counts.get("calls", 0) >= 1 for counts in shards.values())
    for key, total in whole.items():
        assert sum(c.get(key, 0) for c in shards.values()) == total, key
    mesh.disable_mesh()
    telemetry.clear()
    fn(CPU)
    assert telemetry.by_shard() == {}


def test_shard_bounds():
    assert mesh.shard_bounds(5) == [(0, 5)]
    mesh.set_mesh([CPU] * 3)
    assert mesh.shard_bounds(8) == [(0, 2), (2, 5), (5, 8)]
    assert mesh.shard_bounds(2) == [(0, 0), (0, 1), (1, 2)]
    assert mesh.shard_map(lambda xs, dev: [x * 2 for x in xs], CPU,
                          list(range(7))) == [x * 2 for x in range(7)]
    assert mesh.shard_map(lambda xs, dev: xs, CPU, []) == []


def test_a_call_on_another_device_type_raises():
    mesh.set_mesh([torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="cpu call under a mesh of cuda"):
        flank_align_batch_multi([b"ACGT"], [b"ACGT"], 2, 5, 1, CPU)


def test_dryrun_eight_cpu():
    from trgt_tpu_torch.engine.sharding import dryrun
    dryrun(8, "cpu")
    assert mesh.current_mesh() is None


def test_overrides(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    # unset: no mesh, even over four cards, and a caller's mesh kept
    assert mesh.auto_enable("cuda") is None
    assert mesh.auto_enable("cpu") is None
    mesh.set_mesh([CPU] * 8)
    assert mesh.auto_enable("cpu") == [CPU] * 8
    monkeypatch.setenv("TRGT_TPU_MESH", "0")
    assert mesh.auto_enable("cpu") is None and mesh.current_mesh() is None
    monkeypatch.setenv("TRGT_TPU_MESH", "3")
    assert mesh.auto_enable("cuda") == cuda[:3]
    assert mesh.batch_multiple() == 3
    monkeypatch.setenv("TRGT_TPU_MESH", "1")
    assert mesh.auto_enable("cuda") is None and mesh.batch_multiple() == 1
    # more than are visible
    monkeypatch.setenv("TRGT_TPU_MESH", "5")
    with pytest.raises(ValueError, match="only 4 cuda visible"):
        mesh.auto_enable("cuda")
    monkeypatch.setenv("TRGT_TPU_MESH", "2")
    with pytest.raises(ValueError, match="only 1 cpu visible"):
        mesh.auto_enable("cpu")
    with pytest.raises(ValueError, match="one device type"):
        mesh.set_mesh([CPU, cuda[0]])


def test_genotype_run_installs_the_env_mesh(monkeypatch, tmp_path):
    """A device run of the CLI takes TRGT_TPU_MESH: over more CPU devices
    than there are it fails; with 0 it runs with no mesh."""
    from trgt_tpu_torch.cli import main
    from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset
    fasta, bed, bam = make_dataset(
        str(tmp_path), [SynthLocus("HET", "CAG", 10, (10, 20))], depth=8)
    argv = ["genotype", "--genome", fasta, "--repeats", bed, "--reads",
            bam, "--output-prefix", str(tmp_path / "out"), "--device", "cpu"]
    monkeypatch.setenv("TRGT_TPU_MESH", "2")
    assert main(argv) == 1
    mesh.set_mesh([CPU] * 2)
    monkeypatch.setenv("TRGT_TPU_MESH", "0")
    assert main(argv) == 0
    assert mesh.current_mesh() is None


@pytest.mark.cuda
def test_cuda_two_entry_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for name, fn in entry_point_cases():
        plain = fn(dev)
        mesh.set_mesh([dev, dev])
        telemetry.clear()
        assert fn(dev) == plain, name
        assert telemetry.totals(telemetry.snapshot())[name]["launches"] \
            >= 2, name
        # the launches by shard: both shards launched
        assert all(telemetry.totals(telemetry.by_shard()[k])[name]
                   ["launches"] for k in range(2)), name
        mesh.disable_mesh()
    from trgt_tpu_torch.engine.sharding import dryrun
    dryrun(2, "cuda")
