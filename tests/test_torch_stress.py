"""The anchors of chip_smoke.py's phases 7-8 and 15-17, held on the CPU.

chip_smoke.py pins md5s that trgt_tpu makes: of the generated bench96,
adversarial, noisy and 10^4-locus catalogs, and of the VCF body and
spanning-BAM records of trgt_tpu genotype runs on them. On the card it
holds the port's `--device cuda` against those pins, since that machine
has no JAX. Here:

- both generators (trgt_tpu's synth and the port's copy) make the pinned
  repeats.bed and ref.fasta, so a generator difference on the card's
  machine is told apart from a genotyping one;
- trgt_tpu makes the pinned records: bench96 under --device host, both
  presets; the noisy catalogs under --device cpu (its device path,
  float32 Viterbi) and --device host (float64); the adversarial
  catalog under --device host, size and cluster genotypers; the 10^4
  catalog under --device host -t 6 (slow: several minutes on 8 CPUs, so
  the tier-1 run leaves it out);
- the port's --device host makes the float64 anchor (its --device cpu
  the float32 one: test_torch_stress_cpu.py);
- the count of noisy records in which trgt_tpu's two paths differ is the
  pinned NOISY_SPLIT (ROADMAP C4): none on the noisy catalog, some on the
  C4 catalog of another seed, and one on a 100-locus noisy catalog (slow:
  about seven minutes)."""

import importlib.util
import os

import pytest
import torch

from trgt_tpu.cli import main as trgt_tpu_main
from trgt_tpu.utils import synth as ref_synth
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.utils import synth as port_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()
MAKERS = {"bench96": cs.make_bench, "adversarial": cs.make_adversarial,
          "noisy": cs.make_noisy, "noisy_c4": cs.make_noisy_c4}
PKGS = {"trgt_tpu": trgt_tpu_main, "port": port_main}
SMALL_RUNS = [key for key in cs.RUN_MD5 if key[0] != "scale"]
# the runs of trgt_tpu --device host that the port's --device host must
# equal (its --device cpu: test_torch_stress_cpu.py)
HOST_RUNS = [key for key in SMALL_RUNS if key[2] == "host"]


@pytest.fixture(scope="module")
def threads():
    """The port's plain flank version dominates its --device cpu runs on
    noisy reads and spreads over intra-op threads; other test modules set
    one thread at import, so this module sets more only while it runs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def run(tmp_path_factory, threads):
    """run(pkg, catalog, preset or genotyper, device) -> output prefix;
    each catalog made (by trgt_tpu's synth) and each run made once."""
    dirs, done = {}, {}

    def go(pkg, catalog, kind, device):
        key = (pkg, catalog, kind, device)
        if catalog not in dirs:
            dirs[catalog] = str(tmp_path_factory.mktemp(catalog))
            MAKERS[catalog](ref_synth, dirs[catalog])
        if key not in done:
            d = dirs[catalog]
            if catalog == "adversarial":
                preset, reads, extra = "wgs", "reads.bam", ["--genotyper",
                                                            kind]
            else:
                preset, extra = kind, []
                reads = "reads.bam" if kind == "wgs" else \
                    cs.low_quality_reads(d)
            prefix = os.path.join(d, "_".join(key))
            rc = PKGS[pkg](["genotype", "--genome",
                            os.path.join(d, "ref.fasta"), "--repeats",
                            os.path.join(d, "repeats.bed"), "--reads",
                            os.path.join(d, reads), "--preset", preset,
                            "--output-prefix", prefix, "--device", device,
                            *extra])
            assert rc == 0
            done[key] = prefix
        return done[key]
    return go


def test_pins_read_without_a_cuda_context():
    assert not torch.cuda.is_initialized()
    md5s = [m for files in cs.FILE_MD5.values() for m in files.values()]
    md5s += [m for pair in cs.RUN_MD5.values() for m in pair]
    assert all(len(m) == 32 and int(m, 16) >= 0 for m in md5s)
    assert {key[0] for key in cs.RUN_MD5} == set(cs.FILE_MD5)
    assert set(cs.NOISY_SPLIT) == {(catalog, preset) for catalog, presets
                                   in cs.NOISY_PRESETS.items()
                                   for preset in presets}
    assert cs.NOISY_SPLIT[("noisy_c4", "targeted")] > 0


@pytest.mark.parametrize("generator", ["trgt_tpu", "port"])
@pytest.mark.parametrize("catalog", sorted(MAKERS))
def test_generators_make_pinned_files(tmp_path, catalog, generator):
    synth = ref_synth if generator == "trgt_tpu" else port_synth
    MAKERS[catalog](synth, str(tmp_path))
    got = {name: cs.file_md5(str(tmp_path / name))
           for name in cs.FILE_MD5[catalog]}
    assert got == cs.FILE_MD5[catalog]


@pytest.mark.parametrize("key", SMALL_RUNS, ids="-".join)
def test_trgt_tpu_makes_pinned_records(run, key):
    assert cs.records_md5(run("trgt_tpu", *key)) == cs.RUN_MD5[key]


@pytest.mark.parametrize("key", HOST_RUNS, ids="-".join)
def test_port_host_makes_anchor_records(run, key):
    """The port's --device host (the host twins, float64 Viterbi) makes
    trgt_tpu --device host's records."""
    assert cs.records_md5(run("port", key[0], key[1], "host")) == \
        cs.RUN_MD5[key]


@pytest.mark.parametrize("key", sorted(cs.NOISY_SPLIT), ids="-".join)
def test_noisy_split_count(run, key):
    """trgt_tpu's device path and host twins on the noisy catalogs: the
    count of VCF records that differ is the one chip_smoke.py pins (on
    the C4 catalog it gates the card's run on it)."""
    catalog, preset = key
    bodies = [cs.records(run("trgt_tpu", catalog, preset, device))[0]
              for device in ("cpu", "host")]
    n = cs.n_differing(*bodies)
    print(f"{catalog} {preset}: {n} of {cs.NOISY_LOCI} records differ "
          f"between trgt_tpu --device cpu and --device host")
    assert n == cs.NOISY_SPLIT[key]


@pytest.mark.slow
@pytest.mark.parametrize("preset,want", [("wgs", 0), ("targeted", 1)])
def test_noisy_split_count_on_100_loci(tmp_path, preset, want):
    """A 100-locus noisy catalog (seed 11): under --preset targeted one
    record's allele purity (AP) differs between trgt_tpu --device cpu and
    --device host, the float32 and float64 Viterbi paths; ROADMAP C4."""
    d = str(tmp_path)
    cs.make_noisy(ref_synth, d, n=100, seed=11)
    reads = "reads.bam" if preset == "wgs" else cs.low_quality_reads(d)
    bodies = []
    for device in ("cpu", "host"):
        prefix = os.path.join(d, device)
        assert trgt_tpu_main(["genotype", "--genome",
                              os.path.join(d, "ref.fasta"), "--repeats",
                              os.path.join(d, "repeats.bed"), "--reads",
                              os.path.join(d, reads), "--preset", preset,
                              "--output-prefix", prefix, "--device",
                              device]) == 0
        bodies.append(cs.records(prefix)[0])
    assert cs.n_differing(*bodies) == want


@pytest.mark.slow
def test_scale_anchor(tmp_path):
    """The 10^4-locus catalog (benchmarks/scale10k.py's) under trgt_tpu
    --device host -t 6: the pinned files and records, and every
    error-free locus's AL equal to the truth."""
    import json
    d = ref_synth.cached_hetero_dataset(cs.SCALE_LOCI, seed=cs.SEED,
                                        tag="scale", root=str(tmp_path))
    got = {name: cs.file_md5(os.path.join(d, name))
           for name in cs.FILE_MD5["scale"]}
    assert got == cs.FILE_MD5["scale"]
    prefix = os.path.join(d, "scale_host")
    assert trgt_tpu_main(["genotype", "--genome",
                          os.path.join(d, "ref.fasta"), "--repeats",
                          os.path.join(d, "repeats.bed"), "--reads",
                          os.path.join(d, "reads.bam"), "--output-prefix",
                          prefix, "--device", "host", "-t", "6"]) == 0
    assert cs.records_md5(prefix) == cs.RUN_MD5[("scale", "wgs", "host")]
    with open(os.path.join(d, "truth.json")) as fh:
        n, failures = cs.truth_check(cs.records(prefix)[0], json.load(fh))
    assert n > 0 and not failures
