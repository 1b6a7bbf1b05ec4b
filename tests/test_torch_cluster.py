"""The port's catalog cluster (mesh.initialize_distributed), the counterpart
of tests/test_distributed.py: two `genotype --shard-count 2` processes join
one gloo group through TRGT_COORDINATOR_ADDRESS, and their riffled shard
records equal the port's unsharded run and trgt_tpu's, on the same 40 loci,
seeds and depth. A rank that finishes long after its peer leaves the group
cleanly on both sides. Without the address a shard runs standalone; with
it, a rank whose peer never comes raises instead of running standalone."""

import logging
import os
import random
import sys
import time

import pytest
import torch
import torch.distributed as dist

from trgt_tpu.cli import main as trgt_tpu_main
from trgt_tpu.io.bgzf import BgzfReader
from trgt_tpu_torch import mesh
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the ranks are started as chip_smoke's cluster phase starts them
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

# one shard process: it records the group's rank and size while the group
# is up (just before the runner leaves it) and the foreign modules it loaded.
# CLUSTER_TEST_JOIN_S and CLUSTER_TEST_EXIT_S set the module's two timeouts,
# rank 1 takes CLUSTER_TEST_LAG_S more seconds after its shard and, with
# CLUSTER_TEST_VANISH, then ends without leaving the group.
_CHILD = r"""
import os, sys, time
import torch.distributed as dist
from trgt_tpu_torch import mesh
from trgt_tpu_torch.cli import main
for var, name in (("CLUSTER_TEST_JOIN_S", "DISTRIBUTED_TIMEOUT_S"),
                  ("CLUSTER_TEST_EXIT_S", "EXIT_TIMEOUT_S")):
    if var in os.environ:
        setattr(mesh, name, float(os.environ[var]))
lag = float(os.environ.get("CLUSTER_TEST_LAG_S", "0"))
group = []
leave = mesh.shutdown_distributed

def shutdown():
    group.append((dist.get_rank(), dist.get_world_size()))
    if dist.get_rank() == 1:
        time.sleep(lag)
        if "CLUSTER_TEST_VANISH" in os.environ:
            os._exit(0)
    leave()

mesh.shutdown_distributed = shutdown
rc = main(sys.argv[1:])
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "trgt_tpu"))
print("rc", rc, "group", group, "initialized", dist.is_initialized(),
      "foreign", foreign)
"""


def vcf_records(prefix):
    data = BgzfReader(prefix + ".vcf.gz").read_all().decode()
    return [line for line in data.splitlines()
            if line and not line.startswith("#")]


@pytest.fixture(scope="module")
def forty_loci(tmp_path_factory):
    """The 40 loci of tests/test_distributed.py, made by the port's synth."""
    td = tmp_path_factory.mktemp("torch_cluster")
    rng = random.Random(7)
    motifs = ["CAG", "GGC", "AT", "AAAG"]
    loci = []
    for i in range(40):
        motif = motifs[i % len(motifs)]
        ref = rng.randint(5, 14)
        a1 = max(2, ref + rng.randint(-3, 5))
        a2 = max(2, ref + rng.randint(-3, 5))
        loci.append(SynthLocus(f"D{i:02d}", motif, ref, (a1, a2)))
    fasta, bed, bam = make_dataset(str(td), loci, depth=8, flank=320,
                                   read_flank=280, seed=5)
    return td, fasta, bed, bam


def argv(dataset, prefix, *extra):
    _, fasta, bed, bam = dataset
    return ["genotype", "--genome", fasta, "--repeats", bed, "--reads", bam,
            "--output-prefix", str(prefix), "--disable-bam-output", *extra]


@pytest.fixture(scope="module")
def port_whole(forty_loci):
    """The port's unsharded records (--device cpu)."""
    prefix = forty_loci[0] / "port"
    assert port_main(argv(forty_loci, prefix, "--device", "cpu")) == 0
    return vcf_records(str(prefix))


def run_cluster(dataset, tag, device, **env_extra):
    """Two shard processes joined through TRGT_COORDINATOR_ADDRESS; the
    riffle of their records, and each child's (stdout, stderr)."""
    td = dataset[0]
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    workdir = td / f"{tag}_logs"
    workdir.mkdir(exist_ok=True)
    results = cs.run_ranks(_CHILD, lambda k: [
        "-v", *argv(dataset, td / f"{tag}{k}", "--device", device,
                    "--shard-count", "2", "--shard-index", str(k))],
        2, env, str(workdir))
    for k, (rc, out, err) in enumerate(results):
        assert rc == 0, err[-3000:]
        assert out.splitlines()[-1] == (
            f"rc 0 group [({k}, 2)] initialized False foreign []"), out
        assert f"torch.distributed initialized: process {k}/2" in err, err
    shards = [vcf_records(str(td / f"{tag}{k}")) for k in range(2)]
    riffled = [shards[i % 2][i // 2]
               for i in range(sum(len(s) for s in shards))]
    return riffled, [(out, err) for _, out, err in results]


def test_two_process_cluster_shards(forty_loci, port_whole):
    prefix = forty_loci[0] / "ref"
    assert trgt_tpu_main(argv(forty_loci, prefix, "--device", "host")) == 0
    assert len(port_whole) == 40
    riffled, _ = run_cluster(forty_loci, "cpu", "cpu")
    assert riffled == port_whole
    assert riffled == vcf_records(str(prefix))


def test_rank_finishing_long_after_its_peer(forty_loci, port_whole):
    """Rank 1 finishes its shard after rank 0 has waited longer than the
    join timeout: the exit barrier has a timeout of its own, so both ranks
    leave cleanly, exit 0 and write their whole shards."""
    riffled, outs = run_cluster(
        forty_loci, "lag", "cpu", CLUSTER_TEST_JOIN_S="8",
        CLUSTER_TEST_EXIT_S="120", CLUSTER_TEST_LAG_S="12")
    assert riffled == port_whole
    for _, err in outs:
        assert "torch.distributed shut down" in err, err
        assert "leaving before every peer finished" not in err, err


def test_peer_that_vanishes_at_the_end(forty_loci, port_whole):
    """Rank 1 ends without leaving the group: rank 0, whose shard is
    complete, logs that it left before every peer finished and exits 0."""
    td = forty_loci[0]
    env = dict(os.environ, OMP_NUM_THREADS="1", CLUSTER_TEST_VANISH="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    workdir = td / "vanish_logs"
    workdir.mkdir(exist_ok=True)
    results = cs.run_ranks(_CHILD, lambda k: [
        "-v", *argv(forty_loci, td / f"vanish{k}", "--device", "cpu",
                    "--shard-count", "2", "--shard-index", str(k))],
        2, env, str(workdir))
    (rc0, out0, err0), (rc1, _, _) = results
    assert (rc0, rc1) == (0, 0), err0[-3000:]
    assert "leaving before every peer finished" in err0, err0
    assert out0.splitlines()[-1] == (
        "rc 0 group [(0, 2)] initialized False foreign []"), out0
    assert vcf_records(str(td / "vanish0")) == port_whole[0::2]


def test_shard_without_an_address_runs_standalone(forty_loci, port_whole,
                                                  monkeypatch, caplog):
    monkeypatch.delenv("TRGT_COORDINATOR_ADDRESS", raising=False)
    caplog.set_level(logging.INFO, logger="trgt")
    td = forty_loci[0]
    assert port_main(argv(forty_loci, td / "alone1", "--device", "cpu",
                          "--shard-count", "2", "--shard-index", "1")) == 0
    assert "Shard 1/2 running standalone" in caplog.text
    assert not dist.is_initialized()
    assert vcf_records(str(td / "alone1")) == port_whole[1::2]


def test_lone_rank_raises(forty_loci, monkeypatch):
    """Rank 1 of 2 with nobody at the address: the rendezvous times out and
    raises, both alone and through the CLI, which then writes nothing."""
    monkeypatch.setattr(mesh, "DISTRIBUTED_TIMEOUT_S", 2)
    monkeypatch.setenv("TRGT_COORDINATOR_ADDRESS",
                       f"127.0.0.1:{cs.free_port()}")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="timed out"):
        mesh.initialize_distributed(1, 2, "cpu")
    assert time.perf_counter() - t0 < 60
    assert not dist.is_initialized()
    prefix = forty_loci[0] / "lone1"
    assert port_main(argv(forty_loci, prefix, "--device", "cpu",
                          "--shard-count", "2", "--shard-index", "1")) == 1
    assert not os.path.exists(f"{prefix}.vcf.gz")
    assert not dist.is_initialized()


def test_shutdown_without_a_group_does_nothing():
    assert not dist.is_initialized()
    mesh.shutdown_distributed()
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_cuda_two_ranks_on_one_card(forty_loci, port_whole):
    """Both ranks on cuda:0 (gloo lets two ranks share a card): the riffle
    equals the port's unsharded run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    riffled, _ = run_cluster(forty_loci, "cuda", "cuda")
    assert riffled == port_whole
