"""Smoke run of the PyTorch/CUDA port (trgt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:
  1. environment  card name and power limit, torch/CUDA/nvcc versions,
                  whether the native host codec (g++ -lz) loaded
  2. build        nvcc builds trgt_tpu_torch/csrc/*.cu for sm_90a
  3. flank        kernel == plain PyTorch version on the card, exactly,
                  on fuzzed problems (pattern 250, texts 30..16384)
  4. viterbi      kernel == plain version, exactly, on multi-motif
                  topologies mixed in each batch, queries up to 10 kb
  5. end to end   `genotype` of the 96-locus heterogeneous bench catalog
                  (trgt_tpu.utils.synth.cached_hetero_dataset) with
                  --device cuda and --device host: identical VCF and
                  spanning-BAM records, both kernels launched; then both
                  kernels are replayed against their plain versions on
                  the inputs the cuda run gave them (Viterbi up to
                  REPLAY_MAX_L)
The second-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import os
import random
import struct
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA_ROOT = os.path.join(REPO, "build", "trgt_tpu_torch", "data")
N_LOCI = 96
SEED = 42
DEVICE = "cuda"
# the main path's Viterbi calls are replayed against the plain version up
# to this padded query length (the plain version walks positions in
# Python; phase 4 covers 10 kb queries)
REPLAY_MAX_L = 4096


def phase(name):
    print(f"== {name}", flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def timed(fn):
    """(result, device milliseconds) of one fn() call, timed with CUDA
    events around it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(kernel, plain, calls):
    """Run the kernel (once to warm, once timed) and the plain version
    (once, timed) on every argument tuple in calls; returns (max_abs_err,
    kernel ms, plain ms), the times summed over the calls."""
    timed(lambda: [kernel(*a) for a in calls])
    got, ms = timed(lambda: [kernel(*a) for a in calls])
    want, plain_ms = timed(lambda: [plain(*a) for a in calls])
    err = max((max_abs_err(g, w) for g, w in zip(got, want)), default=0)
    return err, ms, plain_ms


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def phase_env():
    import torch
    phase("environment")
    print(gpu_name_power(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}")
    from trgt_tpu_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print("nvcc:", nvcc.strip().splitlines()[-1])
    import importlib.util
    triton = importlib.util.find_spec("triton") is not None
    print(f"triton installed: {triton}")
    from trgt_tpu.io import native
    print(f"native host codec loaded: {native.get_lib() is not None}")


def phase_build():
    phase("build")
    from trgt_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.get_lib()
    info = _build.build_info
    print(f"built {os.path.relpath(info['path'], REPO)} from "
          f"{[os.path.relpath(s, REPO) for s in _build.sources()]} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())


def random_dna(rng, n):
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def mutate(rng, seq, rate):
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < rate / 3:
            continue
        out.append(rng.choice(b"ACGT") if r < 2 * rate / 3 else c)
        if rng.random() < rate / 3:
            out.append(rng.choice(b"ACGT"))
    return bytes(out)


def phase_flank(n_problems: int = 2000, seed: int = 7):
    import torch
    from trgt_tpu.kernels.bucket import bucket
    from trgt_tpu_torch.kernels import semiglobal as sg
    phase(f"flank: kernel vs plain, {n_problems} fuzzed problems")
    rng = random.Random(seed)
    dev = torch.device(DEVICE)
    by_width = {}
    for i in range(n_problems):
        pattern = random_dna(rng, 250)
        tlen = int(30 * (16384 / 30) ** rng.random())
        core = mutate(rng, pattern, rng.choice([0.0, 0.05, 0.2]))
        if i % 9 == 0:
            core = core + core                 # duplicate implant: ties
        pad = max(0, tlen - len(core))
        left = rng.randint(0, pad)
        text = (random_dna(rng, left) + core +
                random_dna(rng, pad - left))[:tlen]
        if i % 13 == 0:
            text = random_dna(rng, tlen)       # unrelated text
        by_width.setdefault(bucket(len(text) + 1, minimum=64),
                            []).append((pattern, text))
    calls = []
    for width, probs in sorted(by_width.items()):
        pat, txt, lens = sg.encode_problems([p for p, _ in probs],
                                            [t for _, t in probs], width)
        calls.append([torch.from_numpy(a).to(dev) for a in (pat, txt, lens)]
                     + [2, 6, 1])
    err, ms, plain_ms = compare(sg.flank_align, sg.flank_align_plain, calls)
    print(f"flank fuzz: {n_problems} problems in {len(by_width)} widths, "
          f"max_abs_err {err} (tolerance 0: exact), kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    if err != 0:
        raise AssertionError("flank kernel disagrees with its plain version")


def phase_viterbi(seed: int = 11):
    import torch
    from trgt_tpu.hmm import build_hmm
    from trgt_tpu.kernels.bucket import bucket
    from trgt_tpu_torch.kernels import viterbi as vt
    rng = random.Random(seed)
    motif_sets = [[b"CAG"], [b"CAG", b"A"], [b"AAG", b"CAAC"],
                  [b"AATGG", b"CCATTTTAGG"], [b"T", b"GATA", b"CCATAGG"]]
    hmms = [build_hmm(m) for m in motif_sets]
    # every topology at every length, and the topologies MIXED inside
    # each batch (tables padded to the largest state count); the plain
    # version walks positions in Python, so the lengths stay few
    by_len = {}
    for qlen in (30, 300, 3000, 10000):
        for k, ms in enumerate(motif_sets):
            q = bytearray()
            while len(q) < qlen:
                q += mutate(rng, rng.choice(ms), 0.03)
            by_len.setdefault(bucket(qlen + 2, minimum=64), []).append(
                (hmms[k], bytes(q[:qlen]).decode()))
    n = sum(len(v) for v in by_len.values())
    phase(f"viterbi: kernel vs plain, {n} multi-motif queries")
    calls = [vt.prepare_batch([h for h, _ in items], [q for _, q in items],
                              torch.device(DEVICE))
             for _key, items in sorted(by_len.items())]
    err, ms, plain_ms = compare(vt.viterbi_segs, vt.viterbi_plain, calls)
    print(f"viterbi fuzz: {n} queries of 30..10000 bases in {len(calls)} "
          f"batches, max_abs_err {err} (tolerance 0: exact), kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    if err != 0:
        raise AssertionError("viterbi kernel disagrees with its plain "
                             "version")


class Capture:
    """Keeps the arguments of every call to `module.name` (the kernels'
    device dispatch) while active, so the comparison phase can replay
    the main path's own inputs."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def wrapped(*args):
            self.calls.append(args)
            return orig(*args)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def records(prefix: str):
    """(VCF body without ## lines, spanning-BAM records without header)."""
    from trgt_tpu.io.bgzf import BgzfReader
    vcf = "\n".join(line for line in BgzfReader(prefix + ".vcf.gz")
                    .read_all().decode().splitlines()
                    if not line.startswith("##"))
    data = BgzfReader(prefix + ".spanning.bam").read_all()
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4 + l_name + 4
    return vcf, data[off:]


def run_genotype(dsdir: str, device: str):
    from trgt_tpu.engine import pipeline
    from trgt_tpu_torch.cli import main
    prefix = os.path.join(dsdir, f"smoke_{device}")
    pipeline.STAGE_TIMES.clear()
    t0 = time.perf_counter()
    rc = main(["genotype", "--genome", os.path.join(dsdir, "ref.fasta"),
               "--repeats", os.path.join(dsdir, "repeats.bed"),
               "--reads", os.path.join(dsdir, "reads.bam"),
               "--output-prefix", prefix, "--device", device])
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"genotype --device {device} exited {rc}")
    stages = {k: round(v, 3) for k, v in pipeline.STAGE_TIMES.items()}
    print(f"genotype --device {device}: {N_LOCI} loci in {elapsed:.3f} s = "
          f"{N_LOCI / elapsed:.3f} loci/s; stages (s) {json.dumps(stages)}",
          flush=True)
    return prefix


def phase_e2e():
    import torch
    from trgt_tpu.utils.synth import cached_hetero_dataset
    from trgt_tpu_torch.kernels import semiglobal as sg
    from trgt_tpu_torch.kernels import viterbi as vt
    phase(f"end to end: bench{N_LOCI} catalog, --device cuda vs host")
    t0 = time.perf_counter()
    dsdir = cached_hetero_dataset(N_LOCI, seed=SEED, tag=f"bench{N_LOCI}",
                                  root=DATA_ROOT)
    print(f"dataset {os.path.relpath(dsdir, REPO)} ready in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"card: {gpu_name_power()}")
    with Capture(sg, "flank_align") as fcap, \
            Capture(vt, "viterbi_segs") as vcap:
        sg.launches = 0
        vt.launches = 0
        cuda_prefix = run_genotype(dsdir, DEVICE)
        launches = {"flank": sg.launches, "viterbi": vt.launches}
    print(f"kernel launches in the cuda run: {json.dumps(launches)}")
    host_prefix = run_genotype(dsdir, "host")
    cuda_vcf, cuda_bam = records(cuda_prefix)
    host_vcf, host_bam = records(host_prefix)
    n_rec = sum(1 for line in cuda_vcf.splitlines()
                if not line.startswith("#"))
    print(f"records: {n_rec} VCF, {len(cuda_bam)} spanning-BAM bytes; "
          f"VCF equal {cuda_vcf == host_vcf}, BAM equal "
          f"{cuda_bam == host_bam}")
    if n_rec != N_LOCI or cuda_vcf != host_vcf or cuda_bam != host_bam:
        raise AssertionError("cuda and host genotype outputs differ")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the {name} kernel was never launched on "
                                 f"the main path")

    kernels = []
    for name, cap, kernel, plain, source, replaces in (
            ("flank", fcap, sg.flank_align, sg.flank_align_plain,
             "trgt_tpu_torch/csrc/flank.cu",
             "trgt_tpu/kernels/semiglobal_pallas.py:79"),
            ("viterbi", vcap, vt.viterbi_segs, vt.viterbi_plain,
             "trgt_tpu_torch/csrc/viterbi.cu",
             "trgt_tpu/kernels/viterbi.py:217")):
        calls = cap.calls
        if name == "viterbi":
            calls = [a for a in calls if a[0].shape[1] <= REPLAY_MAX_L]
        err, ms, plain_ms = compare(kernel, plain, calls)
        print(f"{name}: replayed {len(calls)} of {len(cap.calls)} "
              f"main-path calls, max_abs_err {err} (tolerance 0), kernel "
              f"{ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms (total over the replayed calls)")
        if err != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version on the main path's inputs")
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        if name == "flank":
            entry["also_replaces"] = \
                "trgt_tpu/kernels/semiglobal_pallas.py:220"
        kernels.append(entry)
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    phase_env()
    phase_build()
    phase_flank()
    phase_viterbi()
    kernels = phase_e2e()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
