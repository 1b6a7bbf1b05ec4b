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
  catalog, the 2,500-locus targeted catalog and the 10^5 catalog of
  chip_profile.py scale under --device host -t 6 (slow: minutes to half
  an hour on 8 CPUs, so the tier-1 run leaves them out);
- the port's --device host makes the float64 anchor (its --device cpu
  the float32 one: test_torch_stress_cpu.py);
- the count of noisy records in which trgt_tpu's two paths differ is the
  pinned NOISY_SPLIT (ROADMAP C4): none on the noisy catalog, some on the
  C4 catalog of another seed, and one on a 100-locus noisy catalog (slow:
  about seven minutes);
- the port's --device cpu makes trgt_tpu --device host's records on 64
  loci of the targeted catalog's kind, every second read at rq 0.85;
- chip_profile.py scale's memory-flatness rule on made-up samples."""

import importlib.util
import json
import os
import sys

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


def load_chip_profile():
    """chip_profile.py, which imports chip_smoke from the repo's root."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "chip_profile", os.path.join(REPO, "chip_profile.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()
cp = load_chip_profile()
MAKERS = {"bench96": cs.make_bench, "adversarial": cs.make_adversarial,
          "noisy": cs.make_noisy, "noisy_c4": cs.make_noisy_c4}
PKGS = {"trgt_tpu": trgt_tpu_main, "port": port_main}
# the catalogs of cached_hetero_dataset at 2,500 to 10^5 loci: their
# anchors are the slow tests below
LARGE = ("scale", cs.TARGETED_SCALE_TAG, "scale100k")
SMALL_RUNS = [key for key in cs.RUN_MD5 if key[0] not in LARGE]
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


def anchor(root, key, n, tag, preset):
    """A catalog of cached_hetero_dataset(n, tag=tag) under trgt_tpu
    --device host -t 6 (every second read at rq 0.85 under targeted): the
    pinned files and records of `key`, and every error-free locus's AL
    equal to the truth."""
    d = ref_synth.cached_hetero_dataset(n, seed=cs.SEED, tag=tag,
                                        root=str(root))
    got = {name: cs.file_md5(os.path.join(d, name))
           for name in cs.FILE_MD5[key]}
    assert got == cs.FILE_MD5[key]
    reads = "reads.bam" if preset == "wgs" else cs.low_quality_reads(d)
    prefix = os.path.join(d, f"{key}_host")
    assert trgt_tpu_main(["genotype", "--genome",
                          os.path.join(d, "ref.fasta"), "--repeats",
                          os.path.join(d, "repeats.bed"), "--reads",
                          os.path.join(d, reads), "--preset", preset,
                          "--output-prefix", prefix, "--device", "host",
                          "-t", "6"]) == 0
    assert cs.records_md5(prefix) == cs.RUN_MD5[(key, preset, "host")]
    vcf = cs.records(prefix)[0]
    assert sum(1 for line in vcf.splitlines()
               if not line.startswith("#")) == n
    with open(os.path.join(d, "truth.json")) as fh:
        n_truth, failures = cs.truth_check(vcf, json.load(fh))
    assert n_truth > 0 and not failures


@pytest.mark.slow
def test_scale_anchor(tmp_path):
    """The 10^4-locus catalog (benchmarks/scale10k.py's), chip_smoke.py
    phase 17 (several minutes on 8 CPUs)."""
    anchor(tmp_path, "scale", cs.SCALE_LOCI, "scale", "wgs")


@pytest.mark.slow
def test_targeted2500_anchor(tmp_path):
    """The 2,500-locus targeted catalog of chip_smoke.py phase 18 (about
    two minutes on 8 CPUs)."""
    anchor(tmp_path, cs.TARGETED_SCALE_TAG, cs.TARGETED_SCALE_LOCI,
           cs.TARGETED_SCALE_TAG, "targeted")


@pytest.mark.slow
def test_scale100k_anchor(tmp_path):
    """The 10^5-locus catalog of chip_profile.py scale
    (benchmarks/scale10k.py --n 100000): the generator about 15 minutes,
    trgt_tpu about half an hour on 8 CPUs."""
    anchor(tmp_path, "scale100k", cp.SCALE_N, "scale", "wgs")


# the longest TR of test_port_cpu_on_targeted_catalog's loci: the plain
# versions walk positions and pattern rows in Python on the CPU, and at
# 100 bp every pair of a locus's reads goes to the edit-distance kernel
TARGETED_CPU_MAX_TR = 100


def test_port_cpu_on_targeted_catalog(tmp_path, threads):
    """64 loci of phase 18's generator (hetero_loci(64, seed=42), their
    TRs scaled down to at most TARGETED_CPU_MAX_TR bases as make_noisy
    scales them, the read error rates kept), every second read at rq
    0.85, under --preset targeted: the port's --device cpu (the kernels'
    plain versions, float32 Viterbi) writes trgt_tpu --device host's
    records (float64), exactly."""
    d = str(tmp_path)
    loci = ref_synth.hetero_loci(64, seed=cs.SEED)
    for lc in loci:
        over = max(lc.ref_copies, *lc.allele_copies) * len(lc.motif) \
            / TARGETED_CPU_MAX_TR
        if over > 1:
            lc.ref_copies = max(2, int(lc.ref_copies / over))
            lc.allele_copies = tuple(max(2, int(a / over))
                                     for a in lc.allele_copies)
    ref_synth.make_dataset(d, loci, seed=cs.SEED)
    reads = cs.low_quality_reads(d)
    out = {}
    for pkg, device in (("trgt_tpu", "host"), ("port", "cpu")):
        prefix = os.path.join(d, f"{pkg}_{device}")
        assert PKGS[pkg](["genotype", "--genome",
                          os.path.join(d, "ref.fasta"), "--repeats",
                          os.path.join(d, "repeats.bed"), "--reads",
                          os.path.join(d, reads), "--preset", "targeted",
                          "--output-prefix", prefix, "--device",
                          device]) == 0
        out[pkg] = cs.records(prefix)
    assert out["port"][0].count("\n") == 64
    assert out["port"] == out["trgt_tpu"]


def samples(values):
    """(time, MiB) samples one second apart from 0 s."""
    return [(float(t), v) for t, v in enumerate(values)]


@pytest.mark.parametrize("values,peaks,is_flat", [
    # flat: noise under the rule's 64 MiB
    ([1000 + (t * 37) % 50 for t in range(100)],
     [max(1000 + (t * 37) % 50 for t in range(k * 10, k * 10 + 10))
      for k in range(10)], True),
    # growing: 2 MiB a second, 160 MiB from the second tenth to the last
    ([1000 + 2 * t for t in range(100)],
     [1000 + 2 * (k * 10 + 9) for k in range(10)], False),
    # a single spike mid-run: the rule reads the second and last tenths
    ([5000 if t == 55 else 1000 for t in range(100)],
     [5000 if k == 5 else 1000 for k in range(10)], True),
    # a single spike in the last tenth
    ([5000 if t == 95 else 1000 for t in range(100)],
     [5000 if k == 9 else 1000 for k in range(10)], False),
    # 5 % of 4000 MiB (200) is over 64: 150 MiB of growth is flat
    ([4000] * 50 + [4150] * 50, [4000] * 5 + [4150] * 5, True),
    ([4000] * 50 + [4250] * 50, [4000] * 5 + [4250] * 5, False),
    # 64 MiB is over 5 % of 500 MiB (25): 60 MiB is flat, 70 is not
    ([500] * 50 + [560] * 50, [500] * 5 + [560] * 5, True),
    ([500] * 50 + [570] * 50, [500] * 5 + [570] * 5, False),
], ids=["flat", "growing", "spike", "spike_at_end", "share_flat",
        "share_grown", "floor_flat", "floor_grown"])
def test_flatness_summary(values, peaks, is_flat):
    got = cp.tenths(samples(values), 0.0, 99.0)
    assert got == peaks
    assert cp.flat(got) is is_flat


def test_flatness_tenths_edges():
    """Samples outside the run are left out; the run's last instant falls
    in the last tenth; a tenth without a sample decides nothing (not
    flat)."""
    got = cp.tenths([(-1.0, 9999), (0.0, 1), (5.0, 2), (10.0, 3),
                     (10.5, 9999)], 0.0, 10.0)
    assert got == [1, None, None, None, None, 2, None, None, None, 3]
    assert not cp.flat(got)
    assert not cp.flat([1000] * 9 + [None])
