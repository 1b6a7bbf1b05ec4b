"""Device busy share of one `genotype --device cuda` run of the port.

    python3 chip_profile.py [wgs|targeted]
    python3 chip_profile.py scaling
    python3 chip_profile.py streams
    python3 chip_profile.py pool PARENT_TREE [96|384|paths-N|busy[-N][:wgs|:targeted] ...]
    python3 chip_profile.py scale [n=100000] [threads=4] [parent=TREE]
    python3 chip_profile.py release [CELL]

`scale` holds `genotype -t 4 --device cuda` at the JAX package's largest
scale point (benchmarks/scale10k.py --n 100000, CONCORDANCE.md) and at
chip_smoke.py's 10^4 one, in one call: it makes both catalogs of the bench
generator (`cached_hetero_dataset(n, seed=42, tag="scale")`) in child
processes side by side and checks their files against chip_smoke.FILE_MD5,
then runs `python -m trgt_tpu_torch -vv genotype -t 4 --device cuda` as a
child process on the 10^4 catalog and then on the n-locus one. For each
run it prints the wall and loci/s, the peak RSS of the genotype process
and of each worker, nvidia-smi memory.used and the device memory of each
compute process, the busy share, the workers' summed stage seconds,
launches, e2e.routed and allocator MiB, and holds the records against
trgt_tpu --device host -t 6's pins (chip_smoke.RUN_MD5; an n without a
pin is printed only), n VCF records and the truth AL of every error-free
locus. Memory flatness: the peaks of the genotype process's RSS, the
largest worker's RSS, memory.used and the largest compute process's
device memory in each tenth of the run's wall (`tenths`); flat where the
last tenth's peak exceeds the second tenth's by at most 5 % or 64 MiB,
whichever is larger (`flat`). Raises on any failure, a run that is not
flat included. With `parent=TREE` (another checkout, unpacked with `git
archive`) the 10^4 catalog also runs under that tree before this tree's
10^4 run and after its n-locus run (wall and loci/s, records == the pin).
The 10^5 catalog takes about 15 minutes to make, its run 20-30 on the
H100: give the call 3600 s.

`release` times the per-batch `torch.cuda.empty_cache()` of
`BatchPipeline._finish_batch` (ROADMAP C12): `bench_torch.py --cell CELL
--repeats 1` (default scale10k-wgs-t4) under this tree and under a copy
made under build/ without that one line, copy, tree, tree, copy, copy,
tree, on one data root, both trees' kernels built first; each turn's
loci/s, then each side's median and quartiles. Give the call about 20 minutes for the 10^4 cell.

`pool` times `genotype --device cuda` of bench96 under both presets as a
user runs it, one child process per run, in rounds (forward, backward,
forward): the tree at PARENT_TREE (another checkout, unpacked with `git
archive`) at `-t 1` and `-t 4` (read-extraction threads there), and this
tree at `-t 1`, `-t 2` and `-t 4` (worker processes, each on the card),
at `-t 4` with worker 0 on the card and the others on the host twins (the
JAX package's placement), and at `-t 4 --batch-size 8`. It prints every
reading's wall seconds and loci/s, each worker's start-up seconds, and
holds every run's records against this tree's `-t 1`. Then the change's
rows again on a 384-locus catalog from the same generator, and the card's
busy share at `-t 1` and `-t 4` from `nvidia-smi` utilization samples
(every 50 ms) over the run (`busy-N`: on an N-locus catalog). This tree's
`-t N` rows run the worker pool at any catalog size (`runner.POOL_MIN_LOCI`
set to 0; a user's smaller catalog runs on threads). `paths-N` sets the two paths of `-t 4` side by
side on an N-locus catalog of the same generator: this tree at `-t 1`, at
`-t 4` as read-extraction threads (`TRGT_TPU_PROCS=0`), and at `-t 4` as
worker processes at their default batch and at `--batch-size 8`. Parts
can be run alone: `96` (the rows above), `384` (the change's rows on 384
loci), `paths-N` and `busy[-N]`, each for one preset with `:wgs` or
`:targeted`. A `-t N` row also prints where the child's wall
went: the parent's start-up before the spawn, the last end-of-stream and
the last worker exit after it, and the parent's end.

`scaling` times the kernels, whose cost is latency between serial steps,
alone, at shapes that take that cost apart: the Viterbi kernel on one to
128 rows of 4000 bases over motifs of 1 to 30 bases (the silent chain per
position grows with the motif), as ns per position; the flank kernel on
512 problems at every padded width from 64 to 16384 columns (pattern
250), as ns per row and ps per cell; both e2e classes on near-identical
pairs, as us per pattern row by text or band width, each beside a copy of
csrc/e2e.cu built without the traceback (its share is the difference);
the edit-distance kernel as ns per pair by short-side length and batch
size. `streams` records the
(HMMs, queries) of every `viterbi_batch_multi` call of one bench96
targeted run and replays them with the length groups of a call spread
over up to MAX_STREAMS CUDA streams, as the port runs them, and on one
stream, in turns; it prints the host-clock seconds of each. The other
modes: builds the bench catalog of chip_smoke.py, warms the kernels with one
unprofiled run (whose wall time is printed), then repeats the run under
`torch.profiler` and prints: device time summed by kernel name, the
union of all device intervals (kernels and copies), and that union as a
share of the profiled wall time. The profiler slows the host, so the
unprofiled busy share is estimated as union / unprofiled wall as well.
Needs a CUDA device; imports nothing of JAX or of trgt_tpu.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs

CHANGE_TREE = os.path.dirname(os.path.abspath(__file__))


def device_intervals(trace_path):
    """[(start_us, end_us, name)] of every GPU event in a chrome trace."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    out = []
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            out.append((ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
    return sorted(out)


def union_us(intervals) -> float:
    total, cur_start, cur_end = 0.0, None, None
    for start, end, _name in intervals:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def best_ms(fn, repeats=5) -> float:
    """The least device time of `repeats` calls, after one to warm."""
    fn()
    return min(cs.timed(fn)[1] for _ in range(repeats))


def scaling() -> None:
    import random
    import torch
    from trgt_tpu_torch.hmm import build_hmm
    from trgt_tpu_torch.kernels import semiglobal as sg
    from trgt_tpu_torch.kernels import viterbi as vt
    dev = torch.device("cuda")
    rng = random.Random(1)
    qlen = 4000
    print(f"viterbi kernel, queries of {qlen} bases: ms and ns per position")
    for mlen in (1, 2, 4, 8, 16, 30):
        motif = cs.random_dna(rng, mlen)
        hmm = build_hmm([motif])
        sp = hmm.num_states
        for rows in (1, 8, 128, 1024):
            queries = [cs.mutate(rng, motif * (qlen // mlen + 1),
                                 0.03)[:qlen].decode() for _ in range(rows)]
            args = vt.prepare_batch([hmm] * rows, queries, dev)
            ms = best_ms(lambda: vt.viterbi_segs(*args))
            print(f"  motif {mlen:2d} ({sp:3d} states, {args[4]:2d} levels) "
                  f"rows {rows:4d}: {ms:9.3f} ms, "
                  f"{ms * 1e6 / (qlen + 2):8.1f} ns per position")
    print("flank kernel, 512 problems, pattern 250: ms, ns per pattern row, "
          "ps per cell")
    pattern = cs.random_dna(rng, 250)
    for width in (64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
                  3072, 4096, 8192, 16384):
        n = 512 if width <= 4096 else 64
        texts = []
        for _ in range(n):
            core = cs.mutate(rng, pattern, 0.05)
            left = rng.randint(0, max(0, width - 1 - len(core)))
            texts.append((cs.random_dna(rng, left) + core
                          + cs.random_dna(rng, width))[:width - 1])
        pat, txt, lens = sg.encode_problems([pattern] * n, texts, width)
        args = [torch.from_numpy(a).to(dev) for a in (pat, txt, lens)]
        ms = best_ms(lambda: sg.flank_align(*args, 2, 6, 1))
        print(f"  width {width:5d} x {n:3d} problems: {ms:8.3f} ms, "
              f"{ms * 1e6 / 250:9.1f} ns per row, "
              f"{ms * 1e9 / (250 * width * n):8.2f} ps per cell")
    scaling_e2e(rng)
    scaling_editdist(rng)


def without_traceback():
    """csrc/e2e.cu with all three kernels' traceback cut out (they report no
    runs), built beside the library under build/; the loaded copy, to
    stand in as `_build._lib` while a call is timed."""
    import ctypes
    import subprocess
    from trgt_tpu_torch.kernels import _build
    with open(os.path.join(_build.CSRC_DIR, "e2e.cu")) as fh:
        source = fh.read()
    cut = source.replace("traceback(at, pat, txt, lp, lt, out, lane)", "0") \
                .replace("traceback(at, pat, txt, lp, lt, out, tid)", "0")
    if cut.count("const int count = 0;") != 3:
        raise RuntimeError("csrc/e2e.cu: the traceback calls moved")
    out_dir = os.path.join(_build.BUILD_DIR, "without_traceback")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "e2e.cu")
    with open(src, "w") as fh:
        fh.write(cut)
    lib_path = os.path.join(out_dir, "libe2e.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    for name in ("trgt_e2e_scan", "trgt_e2e_band"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def scaling_e2e(rng) -> None:
    import torch
    from trgt_tpu_torch.kernels import _build, e2e
    dev = torch.device("cuda")
    whole = _build.get_lib()
    cut = without_traceback()

    def both(fn):
        """ms with and without the traceback, in turns."""
        times = {}
        for lib in (whole, cut, cut, whole):
            _build._lib = lib
            ms = best_ms(fn)
            times[lib is cut] = min(ms, times.get(lib is cut, ms))
        _build._lib = whole
        return times[False], times[True]

    n_rows = 256
    print(f"e2e full-matrix class, 16 near-identical pairs, pattern "
          f"{n_rows}: ms, us per pattern row, traceback share")
    for width in (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 2048):
        pairs = []
        for _ in range(16):
            t = cs.random_dna(rng, width - 1)
            p = cs.edit_few(rng, (t + cs.random_dna(rng, n_rows))[:n_rows], 4)
            pairs.append((p[:n_rows], t))
        args = [torch.from_numpy(x).to(dev)
                for x in e2e.encode_problems(pairs)]
        ms, ms_cut = both(lambda: e2e.e2e_scan(*args, 2, 5, 1, False))
        print(f"  text {width - 1:5d}: {ms:8.3f} ms, "
              f"{ms * 1e3 / n_rows:7.3f} us per row, traceback "
              f"{100 * (ms - ms_cut) / ms:5.1f} %")
    n_rows = 4000
    print(f"e2e band class, 8 near-identical pairs, pattern {n_rows}, W "
          f"{e2e.BAND_W0}: ms, us per pattern row, traceback share")
    # band widths of extra + 65 lanes, on both sides of each kernel's limit
    for extra in (0, 63, 64, 191, 192, 447, 448, 959, 960, 1983, 1984, 4031,
                  4032, 8000):
        pairs = []
        for _ in range(8):
            p = cs.random_dna(rng, n_rows)
            t = cs.edit_few(rng, p, 8)
            cut_at = rng.randrange(n_rows)
            t = t[:cut_at] + cs.random_dna(rng, extra + len(p) - len(t)) \
                + t[cut_at:]
            pairs.append((p, t[:len(p) + extra]))
        arrays = e2e.encode_problems(pairs)
        ws = np.full(len(pairs), e2e.BAND_W0, dtype=np.int32)
        width = int(e2e.band_geometry(arrays[2], arrays[3], ws)[2].max())
        args = [torch.from_numpy(x).to(dev) for x in arrays + (ws,)]
        ms, ms_cut = both(
            lambda: e2e.e2e_banded(*args, width, 2, 5, 1, False))
        sure = int(e2e.e2e_banded(*args, width, 2, 5, 1, False)[4].sum())
        print(f"  band {width:5d} lanes ({sure} of 8 certified): "
              f"{ms:8.3f} ms, {ms * 1e3 / n_rows:7.3f} us per row, "
              f"traceback {100 * (ms - ms_cut) / ms:5.1f} %")


def scaling_editdist(rng) -> None:
    import torch
    from trgt_tpu_torch.kernels import editdist as ed
    dev = torch.device("cuda")
    print("edit-distance kernel: ms and ns per pair by short side, long "
          "side and batch")
    for la in (1, 8, 32, 64, 100):
        for lb in sorted({la, ed.MAX_OPS // la}):
            for batch in (1, 64, 4096):
                pairs = []
                for _ in range(batch):
                    a = cs.random_dna(rng, la)
                    pairs.append((a, cs.edit_few(
                        rng, (a * (lb // la + 1))[:lb], 4)[:lb]))
                args = [torch.from_numpy(x).to(dev)
                        for x in ed.encode_pairs(pairs, max(lb, 128))]
                ms = best_ms(lambda: ed.edit_distances(*args))
                print(f"  {la:3d} x {lb:5d}, {batch:4d} pairs: {ms:8.4f} "
                      f"ms, {ms * 1e6 / batch:10.1f} ns per pair")


def streams() -> None:
    import torch
    from trgt_tpu_torch.engine import pipeline
    from trgt_tpu_torch.kernels import telemetry
    from trgt_tpu_torch.kernels import viterbi as vt
    from trgt_tpu_torch.utils.synth import cached_hetero_dataset
    dsdir = cached_hetero_dataset(cs.N_LOCI, seed=cs.SEED,
                                  tag=f"bench{cs.N_LOCI}", root=cs.DATA_ROOT)
    reads = cs.low_quality_reads(dsdir)
    with cs.Capture(pipeline, "viterbi_batch_multi") as cap:
        cs.run_genotype(dsdir, reads, "cuda", "targeted")
    calls = cap.calls
    rows = sum(len(c[1]) for c in calls)
    print(f"{len(calls)} viterbi_batch_multi calls, {rows} queries")
    dev = torch.device("cuda")

    def replay_all(n_streams):
        vt.MAX_STREAMS = n_streams
        launches = telemetry.count("viterbi")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for hmms, queries, _dev in calls:
            vt.viterbi_batch_multi(hmms, queries, dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, telemetry.count("viterbi") - launches

    many = vt.MAX_STREAMS
    replay_all(many)                                    # warm
    for n_streams in (many, 1, 1, many, many, 1):
        seconds, launches = replay_all(n_streams)
        print(f"  up to {n_streams:2d} streams: {seconds * 1e3:9.3f} ms for "
              f"{launches} launches")
    vt.MAX_STREAMS = many


# this tree's worker pool at any catalog size (runner.POOL_MIN_LOCI 0), and
# in mode "mixed" with worker 0 on the requested device and the others on
# the host twins, as trgt_tpu/engine/runner.py:146-149 places them: for
# these measurements only
_POOL = r"""
import sys
from trgt_tpu_torch.engine import runner
runner.POOL_MIN_LOCI = 0
if sys.argv[1] == "mixed":
    spec = runner._worker_spec
    def mixed(args, wk, level):
        out = spec(args, wk, level)
        if wk > 0:
            out["args"]["device"] = "host"
        return out
    runner._worker_spec = mixed
from trgt_tpu_torch.cli import main
sys.exit(main(sys.argv[2:]))
"""

# (tree, -t, extra arguments, mode): mode "mixed" puts worker 0 alone on
# the card, "threads" sets TRGT_TPU_PROCS=0 (read-extraction threads of one
# process, the path of -t N before the worker pool)
POOL_ROWS = [("parent", 1, (), ""), ("parent", 4, (), ""),
             ("change", 1, (), ""), ("change", 2, (), ""),
             ("change", 4, (), ""), ("change", 4, (), "mixed"),
             ("change", 4, ("--batch-size", "8"), "")]
POOL_ROWS_384 = [("change", 1, (), ""), ("change", 2, (), ""),
                 ("change", 4, (), ""),
                 ("change", 4, ("--batch-size", "8"), "")]
PATH_ROWS = [("change", 1, (), ""), ("change", 4, (), "threads"),
             ("change", 4, (), ""), ("change", 4, ("--batch-size", "8"), "")]
POOL_ROUNDS = 3


def cli_run(tree, dsdir, reads, preset, prefix, threads, extra=(),
            mode=""):
    """`genotype --device cuda -t N` of `tree` in a child process, logging
    at debug level; (wall seconds, stderr, the epoch it was started at)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = tree
    if mode == "threads":
        env["TRGT_TPU_PROCS"] = "0"
    head = [sys.executable, "-m", "trgt_tpu_torch"]
    if threads > 1 and mode != "threads" and tree == CHANGE_TREE:
        head = [sys.executable, "-c", _POOL, mode or "pool"]
    cmd = head + ["-vv", "genotype",
                  "--genome", os.path.join(dsdir, "ref.fasta"),
                  "--repeats", os.path.join(dsdir, "repeats.bed"),
                  "--reads", os.path.join(dsdir, reads), "--preset", preset,
                  "--output-prefix", prefix, "--device", "cuda", "-t",
                  str(threads), *extra]
    epoch, t0 = time.time(), time.perf_counter()
    proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[3:])} in {tree} exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return wall, proc.stderr, epoch


def row_name(row):
    tree, threads, extra, mode = row
    return (f"{tree} -t {threads}"
            + {"": "", "mixed": " worker 0 on cuda, rest host",
               "threads": " threads"}[mode]
            + (" " + " ".join(extra) if extra else ""))


def pool_rows(trees, dsdir, n_loci, presets, rows):
    """Every row of `rows` POOL_ROUNDS times per preset, in turns; prints
    and returns {(preset, row name): [loci/s, ...]}."""
    out = {}
    for preset in presets:
        reads = cs.low_quality_reads(dsdir) if preset == "targeted" \
            else "reads.bam"
        want = None
        for rnd in range(POOL_ROUNDS):
            for row in (rows if rnd % 2 == 0 else rows[::-1]):
                tree, threads, extra, mode = row
                prefix = os.path.join(dsdir, f"pool_{preset}_{tree}_"
                                      f"t{threads}_{len(extra)}{mode}")
                wall, stderr, epoch = cli_run(trees[tree], dsdir, reads,
                                              preset, prefix, threads, extra,
                                              mode)
                got = cs.records(prefix)
                if want is None:
                    want = got
                if got != want:
                    raise AssertionError(f"{row_name(row)}: records differ "
                                         f"({preset})")
                line = f"{preset} {n_loci} loci, {row_name(row)}: " \
                    f"{wall:.3f} s, {n_loci / wall:.3f} loci/s"
                if tree == "change" and threads > 1 and mode != "threads":
                    workers = cs.worker_lines(stderr, threads)
                    line += "; workers (loci, ready s, done s) " + \
                        json.dumps({w: (v["loci"], v.get("ready"), v["done"])
                                    for w, v in sorted(workers.items())}) + \
                        "; the parent (s) " + json.dumps(
                            cs.pool_timeline(stderr, epoch, wall))
                print(line, flush=True)
                out.setdefault((preset, row_name(row)), []).append(
                    n_loci / wall)
    for (preset, name), rates in out.items():
        print(f"SUMMARY {preset} {n_loci} loci, {name}: loci/s "
              f"{[round(r, 3) for r in rates]}, median "
              f"{float(np.median(rates)):.3f}, spread "
              f"{min(rates):.3f}-{max(rates):.3f}")
    return out


def sampled_busy(trees, dsdir, preset, threads, extra=()):
    """The card's busy share over one run from nvidia-smi's utilization
    samples (percent of the last sample period with a kernel running)."""
    reads = cs.low_quality_reads(dsdir) if preset == "targeted" \
        else "reads.bam"
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.5)
        wall, _, _ = cli_run(trees["change"], dsdir, reads, preset,
                             os.path.join(dsdir, f"busy_{preset}_t{threads}"),
                             threads, extra)
    finally:
        smi.terminate()
        samples = [int(x) for x in smi.communicate()[0].split()
                   if x.strip().isdigit()]
    # drop the half second before the run
    samples = samples[10:]
    print(f"busy {preset} -t {threads} {' '.join(extra)}: "
          f"{float(np.mean(samples)):.2f} % mean of {len(samples)} samples "
          f"over {wall:.3f} s (max {max(samples)} %)", flush=True)


def pool(parent_tree: str, parts=("96", "384", "busy")) -> None:
    """The parts named in `parts`, each `96`, `384`, `paths-N`, `busy` or
    `busy-N`, with `:wgs` or `:targeted` for one preset only. Only `96`
    runs the tree at PARENT_TREE."""
    from trgt_tpu_torch.kernels import _build
    from trgt_tpu_torch.utils.synth import cached_hetero_dataset
    trees = {"parent": os.path.abspath(parent_tree), "change": CHANGE_TREE}
    t0 = time.perf_counter()
    _build.build()
    if any(part.partition(":")[0] == "96" for part in parts):
        subprocess.run([sys.executable, "-c", "from trgt_tpu_torch.kernels "
                        "import _build; _build.build()"], cwd=trees["parent"],
                       env=dict(os.environ, PYTHONPATH=trees["parent"]),
                       check=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    ds96 = cached_hetero_dataset(cs.N_LOCI, seed=cs.SEED,
                                 tag=f"bench{cs.N_LOCI}", root=cs.DATA_ROOT)
    for part in parts:
        name, _, preset = part.partition(":")
        presets = (preset,) if preset else ("wgs", "targeted")
        if name == "96":
            pool_rows(trees, ds96, cs.N_LOCI, presets, POOL_ROWS)
        elif name == "384" or name.startswith("paths-"):
            n = int(name.rpartition("-")[2])
            t0 = time.perf_counter()
            ds = ds96 if n == cs.N_LOCI else cached_hetero_dataset(
                n, seed=cs.SEED, tag=f"bench{n}", root=cs.DATA_ROOT)
            print(f"{n}-locus catalog generated in "
                  f"{time.perf_counter() - t0:.1f} s")
            pool_rows(trees, ds, n, presets,
                      POOL_ROWS_384 if name == "384" else PATH_ROWS)
        elif name == "busy" or name.startswith("busy-"):
            n = int(name.partition("-")[2] or cs.N_LOCI)
            ds = ds96 if n == cs.N_LOCI else cached_hetero_dataset(
                n, seed=cs.SEED, tag=f"bench{n}", root=cs.DATA_ROOT)
            for preset in presets:
                for threads in (1, 4):
                    sampled_busy(trees, ds, preset, threads)
        else:
            raise ValueError(f"unknown pool part {part!r}")


# flat: the last tenth's peak over the second tenth's by at most this
# share of it, or this many MiB, whichever is larger
FLAT_SHARE = 0.05
FLAT_MIB = 64
SCALE_N = 100_000


def tenths(series, start: float, end: float):
    """The peak of the (time, value) samples in each tenth of [start,
    end]; None for a tenth without a sample."""
    peaks = [None] * 10
    span = end - start
    for t, value in series:
        if not start <= t <= end:
            continue
        k = min(9, int((t - start) * 10 / span))
        peaks[k] = value if peaks[k] is None else max(peaks[k], value)
    return peaks


def flat(peaks) -> bool:
    """Whether the last tenth's peak exceeds the second tenth's by at most
    FLAT_SHARE of it or FLAT_MIB, whichever is larger."""
    second, last = peaks[1], peaks[-1]
    if second is None or last is None:
        return False
    return last - second <= max(FLAT_SHARE * second, FLAT_MIB)


def scale_run(dsdir, n, pin, timeout):
    """One `genotype -t 4` child on an n-locus catalog (chip_smoke's
    `scale_run`); prints its memory tenths. Returns (loci/s, {series:
    (peaks, flat)})."""
    _, gpu, numbers, (start, end), wall = cs.scale_run(
        f"scale {n}", dsdir, "reads.bam", "wgs", f"profile_scale_{n}", n,
        pin, timeout=timeout)
    series = {
        "genotype process RSS": [(t, p) for t, p, _ in gpu.rss_series],
        "largest worker RSS": [(t, w) for t, _, w in gpu.rss_series],
        "memory.used": [(t, m) for t, m, _ in gpu.smi_series]}
    if gpu.app_peak:
        series["largest compute process"] = gpu.app_series
    else:
        print(f"scale {n}: nvidia-smi reported no compute process")
    workers = [round(mib, 3) for (kind, _), mib in sorted(gpu.peaks.items())
               if kind == "worker"]
    print(f"scale {n}: peak RSS of each worker (MiB) {json.dumps(workers)}")
    out = {}
    for name, samples in series.items():
        peaks = tenths(samples, start, end)
        out[name] = (peaks, flat(peaks))
        print(f"scale {n}: {name} (MiB), peak in each tenth of the "
              f"{end - start:.3f} s run: {json.dumps(peaks)}; flat "
              f"{out[name][1]}", flush=True)
    print(f"scale {n}: allocator MiB by worker at its end "
          f"{json.dumps(numbers['cuda_memory'])}")
    return n / wall, out


def parent_scale_run(tree, dsdir, threads, turn):
    """The 10^4 catalog under the tree at `tree`, a `genotype -t N` child
    process: prints its wall and loci/s; raises unless its records are
    the pin's."""
    prefix = os.path.join(dsdir, f"profile_scale_parent{turn}")
    wall, _, _ = cli_run(tree, dsdir, "reads.bam", "wgs", prefix, threads)
    same = cs.records_md5(prefix) == cs.RUN_MD5[("scale", "wgs", "host")]
    print(f"parent tree, scale {cs.SCALE_LOCI} (turn {turn}): {wall:.3f} s "
          f"= {cs.SCALE_LOCI / wall:.3f} loci/s; records == the pin {same}",
          flush=True)
    if not same:
        raise AssertionError("the parent tree's records differ from the pin")
    return cs.SCALE_LOCI / wall


def scale(n: int = SCALE_N, threads: int = cs.SCALE_THREADS,
          parent: str = "") -> None:
    from trgt_tpu_torch.kernels import _build
    cs.SCALE_THREADS = threads
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    pins = {cs.SCALE_LOCI: "scale", SCALE_N: "scale100k"}
    sizes = [cs.SCALE_LOCI] + ([n] if n != cs.SCALE_LOCI else [])
    gens = {m: cs.start_generator(m, "scale") for m in sizes}
    dirs = {}
    for m in sizes:
        dirs[m] = cs.wait_generator(gens[m], f"{m}-locus",
                                    timeout=900 if m <= cs.SCALE_LOCI
                                    else 9000)
        if m in pins:
            cs.check_files(pins[m], dirs[m])
        else:
            print(f"{m}-locus catalog: no pinned files")
    if parent:
        subprocess.run([sys.executable, "-c", "from trgt_tpu_torch.kernels "
                        "import _build; _build.build()"], cwd=parent,
                       env=dict(os.environ, PYTHONPATH=parent), check=True)
    parent_rates = [parent_scale_run(parent, dirs[cs.SCALE_LOCI], threads, 1)
                    ] if parent else []
    rates, memory = {}, {}
    for m in sizes:
        pin = (pins[m], "wgs", "host") if m in pins else None
        rates[m], memory[m] = scale_run(dirs[m], m, pin,
                                        timeout=1800 if m <= cs.SCALE_LOCI
                                        else 3300)
    if parent:
        parent_rates.append(parent_scale_run(parent, dirs[cs.SCALE_LOCI],
                                             threads, 2))
    print(f"scale: loci/s at -t {threads} in one call "
          f"{json.dumps({m: round(r, 3) for m, r in rates.items()})}"
          + (f"; the parent tree at {cs.SCALE_LOCI}, before and after "
             f"{[round(r, 3) for r in parent_rates]}" if parent else ""))
    print(cs.gpu_name_power())
    grown = [name for name, (_, ok) in memory[sizes[-1]].items() if not ok]
    if grown:
        raise AssertionError(f"scale {sizes[-1]}: memory not flat: {grown}")


# the per-batch release of the caching allocator (ROADMAP C10, C12)
RELEASE_LINE = "            torch.cuda.empty_cache()\n"
RELEASE_ORDER = ("copy", "tree", "tree", "copy", "copy", "tree")


def release(cell: str = "scale10k-wgs-t4") -> None:
    """The cost of `BatchPipeline._finish_batch`'s per-batch
    `torch.cuda.empty_cache()`: `bench_torch.py --cell CELL --repeats 1`
    under this tree and under a copy made under build/ without that line,
    in turns (RELEASE_ORDER: three runs each), on one data root. Prints
    each turn's loci/s, peak memory.used and summed annotate seconds, then
    each side's median and quartiles."""
    import statistics
    import bench_torch
    copy = os.path.join(cs.REPO, "build", "without_release")
    if os.path.exists(copy):
        shutil.rmtree(copy)
    os.makedirs(copy)
    for name in ("bench_torch.py", "chip_smoke.py", "chip_profile.py"):
        shutil.copy(os.path.join(cs.REPO, name), copy)
    shutil.copytree(os.path.join(cs.REPO, "trgt_tpu_torch"),
                    os.path.join(copy, "trgt_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(copy, "trgt_tpu_torch", "engine", "pipeline.py")
    with open(path) as fh:
        source = fh.read()
    if source.count(RELEASE_LINE) != 1:
        raise RuntimeError("engine/pipeline.py: the release line moved")
    with open(path, "w") as fh:
        fh.write(source.replace(RELEASE_LINE, RELEASE_LINE.replace(
            "torch.cuda.empty_cache()", "pass")))
    trees = {"tree": cs.REPO, "copy": copy}
    # each tree's kernels built before the turns, so that no turn pays it
    for tree in trees.values():
        subprocess.run([sys.executable, "-c", "from trgt_tpu_torch.kernels "
                        "import _build; _build.build()"], cwd=tree,
                       env=dict(os.environ, PYTHONPATH=tree), check=True)
    rates = {"tree": [], "copy": []}
    for turn, side in enumerate(RELEASE_ORDER):
        proc = subprocess.run(
            [sys.executable, os.path.join(trees[side], "bench_torch.py"),
             "--cell", cell, "--repeats", "1", "--data-root", cs.DATA_ROOT],
            cwd=trees[side], capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"{side} turn {turn}: bench_torch.py exited "
                               f"{proc.returncode}:\n{proc.stdout[-2000:]}"
                               f"\n{proc.stderr[-3000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        rate = result["loci_per_s"]["median"]
        rates[side].append(rate)
        print(f"release turn {turn} ({side}): {rate:.3f} loci/s, correct "
              f"{result['correct']}, memory.used peak "
              f"{result['memory_used_mib']} MiB, busy share "
              f"{result['busy_share']}, annotate "
              f"{(result['stages'] or {}).get('annotate')} s, host anchor "
              f"{result['host_loci_per_s']:.3f} loci/s", flush=True)
        print(json.dumps(result), flush=True)
        if not result["correct"]:
            raise AssertionError(f"{side} turn {turn}: not correct")
    for side, values in rates.items():
        q = bench_torch.quartiles(values)
        print(f"release: {side} ({'with' if side == 'tree' else 'without'} "
              f"the per-batch release) loci/s median {q['median']:.3f}, "
              f"p25 {q['p25']:.3f}, p75 {q['p75']:.3f}, runs "
              f"{[round(v, 3) for v in values]}; spread "
              f"{statistics.pstdev(values):.3f}")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    preset = sys.argv[1] if len(sys.argv) > 1 else "targeted"
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if preset == "scale":
        print(cs.gpu_name_power())
        opts = dict(arg.split("=", 1) for arg in sys.argv[2:])
        scale(int(opts.get("n", SCALE_N)),
              int(opts.get("threads", cs.SCALE_THREADS)),
              os.path.abspath(opts["parent"]) if "parent" in opts else "")
        return 0
    if preset == "release":
        print(cs.gpu_name_power())
        release(*sys.argv[2:3])
        print(cs.gpu_name_power())
        return 0
    if preset in ("scaling", "streams"):
        print(cs.gpu_name_power())
        (scaling if preset == "scaling" else streams)()
        return 0
    if preset == "pool":
        print(cs.gpu_name_power())
        pool(sys.argv[2], sys.argv[3:] or ("96", "384", "busy"))
        print(cs.gpu_name_power())
        return 0
    from trgt_tpu_torch.utils.synth import cached_hetero_dataset
    print(cs.gpu_name_power())
    dsdir = cached_hetero_dataset(cs.N_LOCI, seed=cs.SEED,
                                  tag=f"bench{cs.N_LOCI}", root=cs.DATA_ROOT)
    reads = cs.low_quality_reads(dsdir) if preset == "targeted" \
        else "reads.bam"
    cs.run_genotype(dsdir, reads, "cuda", preset)       # build and warm
    t0 = time.perf_counter()
    cs.run_genotype(dsdir, reads, "cuda", preset)
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.run_genotype(dsdir, reads, "cuda", preset)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        intervals = device_intervals(path)
    by_name = {}
    for start, end, name in intervals:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + end - start)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us / 1e3:10.3f} ms  {n:6d} x  {name[:90]}")
    busy_ms = union_us(intervals) / 1e3
    summed_ms = sum(us for _n, us in by_name.values()) / 1e3
    print(f"{preset}: device time summed {summed_ms:.3f} ms, union of "
          f"device intervals {busy_ms:.3f} ms; profiled wall "
          f"{prof_wall:.3f} s (busy {100 * busy_ms / 1e3 / prof_wall:.2f} %"
          f"), unprofiled wall {plain_wall:.3f} s (busy about "
          f"{100 * busy_ms / 1e3 / plain_wall:.2f} %)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
