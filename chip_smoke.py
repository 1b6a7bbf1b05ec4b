"""Smoke run of the PyTorch/CUDA port (trgt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:
  1. environment  card name and power limit, torch/CUDA/nvcc versions,
                  whether the native host codec (g++ -lz) loaded
  2. build        nvcc builds trgt_tpu_torch/csrc/*.cu for sm_90a
  3. flank        kernel == plain PyTorch version on the card, exactly,
                  on fuzzed problems (pattern 250, texts 30..16384) and on
                  texts at every width where the kernel changes class,
                  strip or tile, empty and one-byte texts, pad rows
  4. viterbi      kernel == plain version, exactly, on multi-motif
                  topologies mixed in each batch, queries up to 10 kb;
                  state counts on both sides of 32 and 64, one to five
                  motifs (the run-end state's in-edges on both sides of
                  the kernel's 4-wide tables), a motif of one base,
                  duplicate and zero-probability edges, rows with no
                  valid path (their garbage segments equal too)
  5. editdist     kernel == plain version, exactly, on seeded pairs of
                  0..100 bases a side, some 1 x 10000, short sides on
                  both sides of 32, 64 and 100 against long sides up to
                  10000 / short, and empty sides
  6. e2e          both kernel classes == their plain versions, exactly
                  (score, direction bits, CIGAR runs, certificate), under
                  the scorings (2,5,1) and (1,0,1): the full-matrix class
                  on pairs of 1..1000 bases and on texts at every width
                  where it changes strip or tile; the band class at band
                  widths on both sides of each of its kernels' limits,
                  certified and not; then `e2e_align_batch` ==
                  the host aligner on all of these and on pairs up to 10
                  kb a side: near-identical, with length differences up
                  to 3 kb, divergent ones that are launched again with a
                  wider band, and two whose band passes the caps and
                  goes to the host aligner
  7. wgs path     `genotype` of the 96-locus heterogeneous bench catalog
                  (utils.synth.cached_hetero_dataset) with --device cuda
                  and --device host: identical VCF and spanning-BAM
                  records; flank, Viterbi and e2e kernels launched; then
                  each of them is replayed against its plain version on
                  the inputs the cuda run gave it
  8. targeted     the same catalog with every second read's rq rewritten
     path         to 0.85, `--preset targeted`, cuda vs host: identical
                  records, all four kernels launched; then the same
                  replay of this run's inputs
  9. CRAM input   the longest allele's locus and seven with read errors,
                  their reads written once as BAM and once as CRAM by the
                  port's CramWriter; `genotype --preset wgs --device cuda`
                  of the CRAM launches flank, Viterbi and e2e (counts set
                  to 0 just before, read just after), and its VCF records
                  equal those of the BAM under --device cuda and host, its
                  spanning BAM that of the CRAM under --device host
 10. commands     on the outputs of the cuda runs of 7 and 8: `merge
                  --force-samples` of both VCFs to .vcf.gz and .bcf (each
                  sample column equals its input's FORMAT fields, the BCF
                  read back equals the VCF); `plot` of the longest allele's
                  locus and a two-motif locus, allele and waterfall, .svg
                  (parsed) and .pdf; `validate` of the catalog (96 pass)
 11. merge at     8 synthetic single-sample VCFs of 10,000 sites (shared
     scale        and private sites, alleles per sample) merged by `python
                  -m trgt_tpu_torch merge` to .vcf.gz and .bcf: seconds,
                  peak RSS, record count == distinct sites, BCF == VCF
 12. worker pool  a 256-locus catalog of the same generator (64 loci a
                  worker at -t 4: a smaller catalog runs on threads)
                  under both presets as child processes `python -m
                  trgt_tpu_torch -vv genotype -t 1/2/4 --device cuda`:
                  -t 2 and -t 4 write the records of -t 1, every
                  worker that wrote a record launched Viterbi (its
                  counters, logged at debug level), and the workers
                  together launched every kernel of the path; the walls
 13. mesh         `engine.sharding.dryrun(2, "cuda")` over [cuda:0,
                  cuda:0], then the wgs path under that mesh: the records
                  of phase 7, flank, Viterbi and e2e launched on both
                  shards (the wrappers' launches, which telemetry also
                  counts by the shard whose thread made them)
 14. karyotype    a haploid chrX locus under --karyotype XY and a
     and shards   zero-ploidy chrY locus (cuda == host, the expected GT),
                  and a 3-way --shard-index/--shard-count split of the
                  bench catalog under cuda whose records together equal
                  phase 7's host run
The launch counts and the bounds come from the kernels' own counters
(trgt_tpu_torch/kernels/telemetry.py), set to 0 just before a run and
read just after; a worker process's are logged by the worker.
Both replays time the kernel and reckon its bound over every call of the
path, and hold every call against the plain version. The plain banded e2e
walks pattern rows in Python, so the problems of all band calls of a path
go through it in a few batches, against which each call's kernel output
is held problem by problem. The plain Viterbi
takes dense tables built from the HMMs' edge lists, not from the kernel's
sparse ones. It walks positions in Python, at a cost that hardly depends
on the number of rows: the rows of all calls up to a padded query length
of REPLAY_MAX_L it runs as one batch, those of all longer calls as
another, against which each call's kernel output is held row by row. The
second-to-last line is
{"kernels": [...]}: one entry per kernel with the targeted path's numbers
and, under "wgs_path", the same numbers of the wgs path, under "cram_path"
the launches of phase 9, under "pool_path" the launches of the targeted
-t 4 workers of phase 12 together, and under "mesh_path" the launches of
phase 13 by shard. The last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of trgt_tpu.
"""

import contextlib
import importlib.util
import io
import json
import os
import random
import re
import struct
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA_ROOT = os.path.join(REPO, "build", "trgt_tpu_torch", "data")
N_LOCI = 96
SEED = 42
DEVICE = "cuda"
# a path's Viterbi calls up to this padded query length share one plain
# batch, the longer ones another (the plain version walks positions in
# Python, a quarter to half a second per 100 positions whatever the batch
# holds)
REPLAY_MAX_L = 1024
# the Viterbi kernel is also timed over the calls up to this padded query
# length alone ("ms_prev_calls"): the calls that the time of the kernel
# before its redesign covered (PERF.md's kernel table keeps that time)
PREV_MAX_L = 4096
# the e2e kernels are also timed over the calls all of whose problems have
# at most this many bucketed cells ("ms_prev_problems"): the problems the
# kernel took before it had a band class, all others then going to the host
# aligner (PERF.md's kernel table keeps the time of that kernel)
PREV_DEVICE_CELLS = 1 << 20


def phase(name):
    print(f"== {name}", flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# cycles the card spins before a timed call starts (about 1.5 ms)
SPIN_CYCLES = 3_000_000


def timed(fn):
    """(result, device milliseconds) of one fn() call, timed with CUDA
    events around it. The card spins first, so that the host has enqueued
    a short call's kernels before the first event passes: the time is the
    device's, not the wrapper's Python between the two events (some 0.05
    ms a call, which times taken without the spin include)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b) -> int:
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise AssertionError(f"{len(a)} outputs != {len(b)}")
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def compare(kernel, plain, calls, plain_calls=None):
    """Call by call: run the kernel (once to warm, once timed) and the
    plain version (once, timed) on the argument tuple (the plain version
    on that of `plain_calls`, where it takes the same inputs in another
    form) and compare them; returns (max_abs_err, kernel ms, plain ms),
    the times summed over the calls. Results are dropped call by call to
    bound device memory."""
    err, ms, plain_ms = 0, 0.0, 0.0
    for args, plain_args in zip(calls, plain_calls or calls):
        kernel(*args)
        got, t = timed(lambda: kernel(*args))
        ms += t
        want, t = timed(lambda: plain(*plain_args))
        plain_ms += t
        err = max(err, max_abs_err(got, want))
    return err, ms, plain_ms


def kernel_table():
    from trgt_tpu_torch.kernels import e2e, editdist
    from trgt_tpu_torch.kernels import semiglobal as sg
    from trgt_tpu_torch.kernels import viterbi as vt
    return {
        "flank": dict(module=sg, fn="flank_align", plain=sg.flank_align_plain,
                      source="trgt_tpu_torch/csrc/flank.cu",
                      replaces="trgt_tpu/kernels/semiglobal_pallas.py:79",
                      also_replaces="trgt_tpu/kernels/"
                                    "semiglobal_pallas.py:220"),
        "viterbi": dict(module=vt, fn="viterbi_segs", plain=vt.viterbi_plain,
                        source="trgt_tpu_torch/csrc/viterbi.cu",
                        replaces="trgt_tpu/kernels/viterbi.py:217"),
        "editdist": dict(module=editdist, fn="edit_distances",
                         plain=editdist.edit_distances_plain,
                         source="trgt_tpu_torch/csrc/editdist.cu",
                         replaces="trgt_tpu/kernels/editdist_pallas.py:41"),
        "e2e": dict(module=e2e, fn="e2e_scan", plain=e2e.e2e_scan_plain,
                    band_fn="e2e_banded", band_plain=e2e.e2e_banded_plain,
                    source="trgt_tpu_torch/csrc/e2e.cu",
                    replaces="trgt_tpu/kernels/e2e_device.py:40"),
    }


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
    triton = importlib.util.find_spec("triton") is not None
    print(f"triton installed: {triton}")
    from trgt_tpu_torch.io import native
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


def edit_few(rng, seq, n_edits):
    """seq with n_edits single-base substitutions, insertions, deletions."""
    b = bytearray(seq)
    for _ in range(n_edits):
        op = rng.random()
        pos = rng.randrange(max(1, len(b)))
        if op < 0.5:
            b[pos:pos + 1] = bytes([rng.choice(b"ACGT")])
        elif op < 0.75:
            b[pos:pos] = bytes([rng.choice(b"ACGT")])
        else:
            del b[pos:pos + 1]
    return bytes(b)


def phase_flank(n_problems: int = 2000, seed: int = 7):
    import torch
    from trgt_tpu_torch.kernels import semiglobal as sg
    from trgt_tpu_torch.kernels.bucket import bucket
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
    # every width at which the kernel changes strip, class or tile (warp
    # class up to 64, 128, 256, 512 columns; block class up to 1024 and
    # 2048, then tiles of 4096), one column to either side; empty and
    # one-byte texts;
    # patterns of unequal length, so shorter ones end in pad rows
    n_edge = 0
    for edge in (1, 2, 64, 128, 256, 512, 1024, 2048, 4096, 8192):
        for tlen in (edge - 2, edge - 1, edge, edge + 1):
            for rep in range(3):
                pattern = random_dna(rng, rng.choice([250, 250, 200, 31]))
                core = mutate(rng, pattern, rng.choice([0.0, 0.1]))
                left = rng.randint(0, max(0, tlen - len(core)))
                text = (random_dna(rng, left) + core
                        + random_dna(rng, tlen))[:max(tlen, 0)]
                by_width.setdefault(bucket(len(text) + 1, minimum=64),
                                    []).append((pattern, text))
                n_edge += 1
    n_problems += n_edge
    calls = []
    for width, probs in sorted(by_width.items()):
        pat, txt, lens = sg.encode_problems([p for p, _ in probs],
                                            [t for _, t in probs], width)
        calls.append([torch.from_numpy(a).to(dev) for a in (pat, txt, lens)]
                     + [2, 6, 1])
    err, ms, plain_ms = compare(sg.flank_align, sg.flank_align_plain, calls)
    print(f"flank fuzz: {n_problems} problems ({n_edge} at class, strip "
          f"and tile edges) in {len(by_width)} widths, "
          f"max_abs_err {err} (tolerance 0: exact), kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    if err != 0:
        raise AssertionError("flank kernel disagrees with its plain version")


def odd_hmm():
    """[CAG, A] with a duplicate and a zero-probability in-edge on the
    first delete state of CAG and only zero-probability edges into the
    second (states: motif start 2, match 3-5, insert 6-8, delete 9-10)."""
    from trgt_tpu_torch.hmm import build_hmm
    hmm = build_hmm([b"CAG", b"A"])
    hmm.set_trans(9, [3, 4, 3], [0.05, 0.0, 0.2])
    hmm.set_trans(10, [4, 9], [0.0, 0.0])
    return hmm


def dense_calls(batches):
    """`viterbi_plain`'s arguments for batches of (hmms, queries): the
    dense tables, built from the HMMs' edge lists and so independent of
    the sparse ones the kernel reads."""
    import torch
    from trgt_tpu_torch.kernels import viterbi as vt
    return [vt.prepare_batch(hmms, queries, torch.device(DEVICE),
                             sparse=False) for hmms, queries in batches]


def phase_viterbi(seed: int = 11):
    import torch
    from trgt_tpu_torch.hmm import build_hmm
    from trgt_tpu_torch.kernels import viterbi as vt
    from trgt_tpu_torch.kernels.bucket import bucket
    rng = random.Random(seed)
    motif_sets = [[b"CAG"], [b"CAG", b"A"], [b"AAG", b"CAAC"],
                  [b"AATGG", b"CCATTTTAGG"], [b"T", b"GATA", b"CCATAGG"]]
    # short queries only (the plain version walks positions in Python):
    # 29, 32 and 35 states; 62 and 65; 63 and 66 from two motifs; four and
    # five motifs (five and six in-edges into the run-end state); a motif
    # of one base alone
    short_sets = [[b"ACGTTGC"], [b"ACGTTGCA"], [b"ACGTTGCAT"],
                  [b"ACGTTGCATGGACTTAAC"], [b"ACGTTGCATGGACTTAACG"],
                  [b"ACGTTGCAT", b"GGACTTAAC"], [b"ACGTTGCATG", b"GGACTTAAC"],
                  [b"A", b"CG", b"TTA", b"GGCA"],
                  [b"A", b"CG", b"TTA", b"GGCA", b"CCTGA"], [b"G"]]
    hmms = [build_hmm(m) for m in motif_sets]
    short_hmms = [build_hmm(m) for m in short_sets] + [odd_hmm()]
    short_sets = short_sets + [[b"CAG", b"A"]]
    # every topology at every length, and the topologies MIXED inside
    # each batch (tables padded to the largest state count)
    by_len = {}
    n_dead = 0
    for qlen in (30, 300, 3000, 10000):
        sets = list(zip(hmms, motif_sets))
        if qlen <= 300:
            sets += list(zip(short_hmms, short_sets))
        for k, (hmm, ms) in enumerate(sets):
            q = bytearray()
            while len(q) < qlen:
                q += mutate(rng, rng.choice(ms), 0.03)
            q = q[:qlen]
            if qlen <= 300 and k % 3 == 0:
                # an N encodes as the '#' sentinel: no valid path, and the
                # traceback walks the invalid states' predecessor words
                q[qlen // 2] = ord("N")
                n_dead += 1
            by_len.setdefault(bucket(qlen + 2, minimum=64), []).append(
                (hmm, bytes(q).decode()))
    n = sum(len(v) for v in by_len.values())
    phase(f"viterbi: kernel vs plain, {n} queries, {n_dead} of them with "
          f"no valid path")
    batches = [([h for h, _ in items], [q for _, q in items])
               for _key, items in sorted(by_len.items())]
    dev = torch.device(DEVICE)
    calls = [vt.prepare_batch(hs, qs, dev) for hs, qs in batches]
    err, ms, plain_ms = compare(vt.viterbi_segs, vt.viterbi_plain, calls,
                                dense_calls(batches))
    dead = sum(int((vt.viterbi_segs(*args)[-1, :, 0] == 0).sum())
               for args in calls)
    print(f"viterbi fuzz: {n} queries of 30..10000 bases over "
          f"{len(hmms) + len(short_hmms)} topologies in {len(calls)} "
          f"batches, {dead} rows without a valid path, max_abs_err {err} "
          f"(tolerance 0: exact, invalid rows included), kernel {ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms")
    if err != 0:
        raise AssertionError("viterbi kernel disagrees with its plain "
                             "version")
    if dead != n_dead:
        raise AssertionError(f"{dead} rows without a valid path, expected "
                             f"{n_dead}")


def phase_editdist(n_pairs: int = 4000, seed: int = 13):
    import torch
    from trgt_tpu_torch.kernels import editdist as ed
    from trgt_tpu_torch.kernels.align_host import edit_distance
    from trgt_tpu_torch.kernels.bucket import bucket
    phase(f"editdist: kernel vs plain, {n_pairs} fuzzed pairs")
    rng = random.Random(seed)
    dev = torch.device(DEVICE)
    pairs = []
    for i in range(n_pairs):
        if i % 100 == 0:
            a, b = random_dna(rng, 1), random_dna(rng, 10000)   # 1 x 10000
        elif i % 3 == 0:
            a = random_dna(rng, rng.randint(0, 100))
            b = random_dna(rng, rng.randint(0, 100))
        else:
            # near-identical: a repeat tract with a few edits
            motif = random_dna(rng, rng.randint(1, 6))
            a = (motif * 100)[:rng.randint(0, 100)]
            b = edit_few(rng, a, rng.randint(0, 4))[:100]
        if len(a) > len(b):
            a, b = b, a
        pairs.append((a, b))
    # short sides on both sides of 32, 64 and 100 (the kernel keeps `a`
    # four bytes a lane), long sides up to MAX_OPS / short and on both
    # sides of one and two tiles of 128 columns; empty sides
    for la in (31, 32, 33, 63, 64, 65, 99, 100, 101, 128):
        for lb in (la, ed.MAX_OPS // la, 126, 127, 128, 129, 255, 256, 257):
            if lb < la:
                continue
            a = random_dna(rng, la)
            pairs.append((a, edit_few(rng, (a * (lb // la + 1))[:lb],
                                      rng.randint(0, 6))[:lb]))
            pairs.append((a, random_dna(rng, lb)))
    pairs += [(b"", b""), (b"", random_dna(rng, 1)),
              (b"", random_dna(rng, 100)), (b"", random_dna(rng, 10000))]
    n_pairs = len(pairs)
    by_width = {}
    for a, b in pairs:
        by_width.setdefault(bucket(len(b), minimum=128), []).append((a, b))
    calls = [[torch.from_numpy(x).to(dev)
              for x in ed.encode_pairs(items, width)]
             for width, items in sorted(by_width.items())]
    err, ms, plain_ms = compare(ed.edit_distances, ed.edit_distances_plain,
                                calls)
    print(f"editdist fuzz: {n_pairs} pairs in {len(calls)} widths, "
          f"max_abs_err {err} (tolerance 0: exact), kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    if err != 0:
        raise AssertionError("edit-distance kernel disagrees with its "
                             "plain version")
    some = pairs[:600] + pairs[4000:]
    got = ed.edit_distances_batch(some, dev)
    want = [edit_distance(a, b) for a, b in some]
    if got != want:
        raise AssertionError("edit_distances_batch disagrees with the host "
                             "twin align_host.edit_distance")
    print(f"editdist: edit_distances_batch == align_host.edit_distance on "
          f"{len(some)} of the pairs")


def insert_block(rng, seq, n):
    """seq with n random bases inserted at one place."""
    at = rng.randrange(len(seq) + 1)
    return seq[:at] + random_dna(rng, n) + seq[at:]


def e2e_fuzz_pairs(rng, n_pairs):
    """Pairs of 1..1000 bases (near-identical, repeat tracts, unrelated),
    and texts one column to either side of every width at which the
    full-matrix class changes strip (64, 128, 256 columns) or tile (512,
    1024)."""
    pairs = []
    for i in range(n_pairs):
        n = int(1000 ** rng.random())                 # 1..1000, log-uniform
        if i % 2 == 0:
            if i % 4 == 0:                            # a repeat tract: ties
                motif = random_dna(rng, rng.randint(1, 6))
                a = (motif * n)[:n]
            else:
                a = random_dna(rng, n)
            b = edit_few(rng, a, rng.randint(0, 4)) or a
            pairs.append((a, b))
        else:
            pairs.append((random_dna(rng, n),
                          random_dna(rng, int(1000 ** rng.random()))))
    for edge in (64, 128, 256, 512, 1024):
        for tlen in (edge - 2, edge - 1, edge, edge + 1):
            t = random_dna(rng, tlen)
            pairs.append((edit_few(rng, t[:rng.randint(1, 300)], 3) or t, t))
            pairs.append((random_dna(rng, rng.randint(1, 300)), t))
    return pairs


def band_fuzz_calls(rng, dev):
    """Calls of the band class: near-identical and unrelated pairs of
    200..900 bases (100..300 against the widest bands), slack 32 and 1,
    length differences that put the band's width one lane to either side
    of each limit at which the kernel changes the lanes a thread owns or
    the warps of a problem (128, 256, 512, 1024, 2048 and 4096 lanes),
    certified and not, the bits rows as wide as the widest band and one
    lane wider."""
    import numpy as np
    import torch
    from trgt_tpu_torch.kernels import e2e
    calls = []
    for w, limits in ((32, (128, 256, 512, 1024, 2048, 4096)),
                      (1, (40, 128, 1024))):
        for limit in limits:
            pairs = []
            for wb in (limit - 1, limit, limit + 1, limit + 2):
                dt = max(0, wb - 2 * w - 1)
                p = random_dna(rng, rng.randint(200, 900) if limit < 2048
                               else rng.randint(100, 300))
                near = edit_few(rng, p, rng.randint(0, 6))
                pairs.append((p, insert_block(rng, near,
                                              dt + len(p) - len(near))))
                pairs.append((pairs[-1][1], p))          # T < P
                pairs.append((p, random_dna(rng, len(p) + dt)))
            arrays = e2e.encode_problems(pairs)
            ws = np.full(len(pairs), w, dtype=np.int32)
            width = int(e2e.band_geometry(arrays[2], arrays[3], ws)[2].max())
            args = [torch.from_numpy(x).to(dev) for x in arrays + (ws,)]
            calls += [args + [width, 2, 5, 1], args + [width + 1, 1, 0, 1]]
    return calls


def big_e2e_pairs(rng):
    """Pairs the band class exists for, up to 10 kb a side: near-identical;
    with a block of up to 3 kb inserted on either side; unrelated ones,
    which fail the first pass's certificate and are launched again. And
    two for the host aligner: a band wider than MAX_BAND_WIDTH at once,
    and one whose second pass would be. Returns (pairs, host-routed)."""
    from trgt_tpu_torch.kernels import e2e
    pairs = []
    for n in (2000, 3500, 5000, 7000, 10000, 10000):
        p = random_dna(rng, n)
        if n == 5000:
            p = (random_dna(rng, 7) * n)[:n]           # a repeat tract: ties
        pairs.append((p, edit_few(rng, p, rng.randint(1, 12))))
    for n, block in ((3000, 100), (6000, 700), (10000, 3000), (7000, 2000)):
        p = random_dna(rng, n - block)
        t = insert_block(rng, edit_few(rng, p, 6), block)
        pairs += [(p, t), (t, p)]
    pairs += [(random_dna(rng, 3000), random_dna(rng, 3100)),
              (random_dna(rng, 2500), random_dna(rng, 2400)),
              (random_dna(rng, 6000), random_dna(rng, 6000))]
    wide = e2e.MAX_BAND_WIDTH
    pairs += [(random_dna(rng, 300), random_dna(rng, 300 + wide)),
              (random_dna(rng, 1000), random_dna(rng, 1000 + wide - 70))]
    return pairs, 2


def phase_e2e_fuzz(n_pairs: int = 240, seed: int = 17):
    import torch
    from trgt_tpu_torch.kernels import e2e
    from trgt_tpu_torch.kernels.align_host import align_end_to_end
    from trgt_tpu_torch.kernels.bucket import bucket
    phase(f"e2e: both kernel classes vs plain and host aligner, two scorings")
    rng = random.Random(seed)
    dev = torch.device(DEVICE)
    pairs = e2e_fuzz_pairs(rng, n_pairs)
    by_key = {}
    for p, t in pairs:
        by_key.setdefault((bucket(len(p)), bucket(len(t))),
                          []).append((p, t))
    band_calls = band_fuzz_calls(rng, dev)
    err, ms, plain_ms = compare(e2e.e2e_banded, e2e.e2e_banded_plain,
                                band_calls)
    sure = sum(int(e2e.e2e_banded(*args)[4].sum()) for args in band_calls)
    n_band = sum(args[0].shape[0] for args in band_calls)
    print(f"e2e band fuzz: {n_band} problems in {len(band_calls)} calls, "
          f"{sure} certified, score/bits/runs/certificate max_abs_err {err} "
          f"(tolerance 0: exact), kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms")
    if err != 0 or not 0 < sure < n_band:
        raise AssertionError("banded e2e kernel disagrees with its plain "
                             "version, or the fuzz lacks certified or "
                             "uncertified problems")
    big, n_host = big_e2e_pairs(rng)
    for mism, gapo, gape in ((2, 5, 1), (1, 0, 1)):
        calls = [[torch.from_numpy(x).to(dev)
                  for x in e2e.encode_problems(items)] + [mism, gapo, gape]
                 for _key, items in sorted(by_key.items())]
        err, ms, plain_ms = compare(e2e.e2e_scan, e2e.e2e_scan_plain, calls)
        print(f"e2e full-matrix fuzz ({mism},{gapo},{gape}): {len(pairs)} "
              f"pairs in {len(calls)} length groups, score/bits/runs "
              f"max_abs_err {err} (tolerance 0: exact), kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms")
        if err != 0:
            raise AssertionError("e2e kernel disagrees with its plain "
                                 "version")
        e2e.routed.clear()
        t0 = time.perf_counter()
        got = e2e.e2e_align_batch(pairs + big, mism, gapo, gape, dev)
        t_dev = time.perf_counter() - t0
        want = [align_end_to_end(p, t, mism, gapo, gape)
                for p, t in pairs + big]
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want))
                       if g != w)
            p, t = (pairs + big)[bad]
            raise AssertionError(f"e2e CIGAR differs from the host aligner "
                                 f"on pair {bad} ({len(p)} x {len(t)})")
        print(f"e2e fuzz ({mism},{gapo},{gape}): scores and CIGARs == "
              f"align_host.align_end_to_end on all {len(got)} pairs, "
              f"{len(big)} of them up to 10 kb a side; e2e_align_batch "
              f"{t_dev:.3f} s, the host aligner one by one "
              f"{time.perf_counter() - t0 - t_dev:.3f} s; routed "
              f"{json.dumps(dict(e2e.routed))}")
        # with free gap opens a short pattern finds its bases in a long
        # unrelated text, and the second of the two certifies at once
        n_want = (n_host,) if gapo else (n_host - 1, n_host)
        if e2e.routed["host_problems"] not in n_want or \
                e2e.routed["band_relaunches"] < 3:
            raise AssertionError("the fuzz did not drive the relaunches and "
                                 "the caps it was built for")


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
    from trgt_tpu_torch.io.bgzf import BgzfReader
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


def run_genotype(dsdir: str, reads: str, device: str, preset: str,
                 repeats: str = "repeats.bed", name: str = "",
                 n_loci: int = N_LOCI, extra=()):
    from trgt_tpu_torch.cli import main
    from trgt_tpu_torch.engine import pipeline
    from trgt_tpu_torch.kernels import e2e
    prefix = os.path.join(dsdir, name or f"smoke_{preset}_{device}")
    pipeline.STAGE_TIMES.clear()
    e2e.routed.clear()
    t0 = time.perf_counter()
    rc = main(["genotype", "--genome", os.path.join(dsdir, "ref.fasta"),
               "--repeats", os.path.join(dsdir, repeats),
               "--reads", os.path.join(dsdir, reads), "--preset", preset,
               "--output-prefix", prefix, "--device", device, *extra])
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"genotype --preset {preset} --device {device} "
                           f"exited {rc}")
    stages = {k: round(v, 3) for k, v in pipeline.STAGE_TIMES.items()}
    print(f"genotype --preset {preset} --device {device} --reads {reads}: "
          f"{n_loci} loci in {elapsed:.3f} s = {n_loci / elapsed:.3f} "
          f"loci/s; stages (s) {json.dumps(stages)}", flush=True)
    if device == "cuda":
        print(f"consensus alignments routed in this run (host_seconds: "
              f"wall time of the host-routed ones, on a thread pool): "
              f"{json.dumps(dict(e2e.routed))}")
    return prefix


def launch_counts(snap):
    """{kernel: launches} of a telemetry snapshot, e2e's two classes
    summed, and e2e_band: the band class's alone."""
    from trgt_tpu_torch.kernels import telemetry
    totals = telemetry.totals(snap)
    out = {name: totals.get(name, {}).get("launches", 0)
           for name in ("flank", "viterbi", "editdist", "e2e")}
    out["e2e_band"] = snap.get("e2e_band", {}).get("launches", 0)
    return out


def drive_path(dsdir, reads, preset, expect):
    """Genotype with --device cuda (kernel inputs captured, the counters
    set to 0 just before and read just after) and --device host; the two
    must write identical records and every kernel in `expect` must have
    been launched. Returns (launches, the run's counters, captures)."""
    from trgt_tpu_torch.kernels import telemetry
    table = kernel_table()
    caps = {name: Capture(k["module"], k["fn"]) for name, k in table.items()}
    # the (hmms, queries) of every Viterbi call, for the plain version's
    # own tables
    caps["viterbi_batches"] = Capture(table["viterbi"]["module"],
                                      "prepare_batch")
    caps["e2e_band"] = Capture(table["e2e"]["module"],
                               table["e2e"]["band_fn"])
    with contextlib.ExitStack() as stack:
        for cap in caps.values():
            stack.enter_context(cap)
        telemetry.clear()
        cuda_prefix = run_genotype(dsdir, reads, DEVICE, preset)
        counts = telemetry.snapshot()
    launches = launch_counts(counts)
    band_launches = launches.pop("e2e_band")
    print(f"kernel launches in the {preset} cuda run: {json.dumps(launches)}"
          f" (e2e: {band_launches} of them the band class's)")
    print(f"telemetry of the {preset} cuda run: {json.dumps(counts)}")
    if band_launches != len(caps["e2e_band"].calls) or \
            launches["e2e"] - band_launches != len(caps["e2e"].calls):
        raise AssertionError("the captured e2e calls do not pair with the "
                             "launch counts")
    for cls, c in counts.items():
        if c.get("calls", 0) != c.get("launches", 0):
            raise AssertionError(f"{cls}: {c.get('calls', 0)} batches "
                                 f"counted, {c.get('launches', 0)} launches")
    host_prefix = run_genotype(dsdir, reads, "host", preset)
    cuda_vcf, cuda_bam = records(cuda_prefix)
    host_vcf, host_bam = records(host_prefix)
    n_rec = sum(1 for line in cuda_vcf.splitlines()
                if not line.startswith("#"))
    print(f"{preset} records: {n_rec} VCF, {len(cuda_bam)} spanning-BAM "
          f"bytes; VCF equal {cuda_vcf == host_vcf}, BAM equal "
          f"{cuda_bam == host_bam}")
    if n_rec != N_LOCI or cuda_vcf != host_vcf or cuda_bam != host_bam:
        raise AssertionError(f"cuda and host genotype outputs differ "
                             f"({preset})")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"the {name} kernel was never launched on "
                                 f"the {preset} path")
    launches["e2e_band"] = band_launches
    return launches, counts, caps


def low_quality_reads(dsdir: str) -> str:
    """reads.bam with every second read's rq rewritten to 0.85 (under 0.9,
    so the targeted preset's impure-read filter labels it)."""
    from trgt_tpu_torch.io.bam import BamReader
    from trgt_tpu_torch.io.bam_write import BamWriter
    name = "reads_low_rq.bam"
    src = BamReader(os.path.join(dsdir, "reads.bam"))
    w = BamWriter(os.path.join(dsdir, name), src.header.text,
                  src.header.references, build_index=True)
    for i, rec in enumerate(src):
        w.write_record(rec.qname, rec.flag, rec.ref_id, rec.pos, rec.mapq,
                       rec.cigar, rec.seq, rec.qual,
                       [("rq", "f", 0.85 if i % 2 else 0.999)])
    w.close()
    return name


def kernel_ms(kernel, calls) -> float:
    """Device milliseconds of the kernel over the calls, each warmed once
    and timed once."""
    total = 0.0
    for args in calls:
        kernel(*args)
        total += timed(lambda: kernel(*args))[1]
    return total


def hold_rows(kernel, plain, calls, batches):
    """The Viterbi kernel's output on each of `calls` against ONE run of
    the plain version over all their rows (`batches`: each call's hmms
    and queries): rows do not act on one another, so a row's segments are
    those of its own call, padded with -1 to the batch's positions and
    levels. Holds for rows with a valid path, which is every row of a
    genotype run that ended. Returns (max_abs_err, plain ms)."""
    args = dense_calls([([h for hmms, _ in batches for h in hmms],
                         [q for _, queries in batches for q in queries])])[0]
    want, plain_ms = timed(lambda: plain(*args))
    err, lo = 0, 0
    for call in calls:
        got = kernel(*call)
        L, B, K = got.shape[0] - 1, got.shape[1], got.shape[2]
        rows = want[:, lo:lo + B]
        lo += B
        if not bool(got[L].all()):
            raise AssertionError("a replayed Viterbi row has no valid path")
        err = max(err, max_abs_err(got[:L], rows[:L, :, :K]),
                  max_abs_err(got[L, :, 0], rows[-1, :, 0]))
        if not (bool((rows[L:-1] == -1).all())
                and bool((rows[:L, :, K:] == -1).all())):
            raise AssertionError("the plain batch's rows are not empty "
                                 "beyond a call's positions and levels")
    if lo != want.shape[1]:
        raise AssertionError(f"{lo} rows held, {want.shape[1]} in the batch")
    return err, plain_ms


# bytes of direction bits one batch of the plain banded e2e may hold
PLAIN_BAND_BYTES = 1 << 30


def hold_band(kernel, plain, calls):
    """The band kernel's output on each of `calls` (bits kept) against the
    plain version run over all their problems in a few batches, longest
    patterns together: problems do not act on one another, so a problem's
    outputs are those of its own call, padded with 0 to the batch's rows
    and lanes. Returns (max_abs_err, plain ms, problems, batches,
    uncertified problems)."""
    import torch
    problems = []                  # (call, row, len_p, call's width)
    for c, args in enumerate(calls):
        problems += [(c, b, lp, args[5])
                     for b, lp in enumerate(args[2].tolist())]
    problems.sort(key=lambda x: (x[2], x[3]))
    batches, cur = [], []
    for prob in problems:
        rows = prob[2] + 1
        width = max([prob[3]] + [q[3] for q in cur])
        if cur and (len(cur) + 1) * rows * width > PLAIN_BAND_BYTES:
            batches.append(cur)
            cur = []
        cur.append(prob)
    if cur:
        batches.append(cur)
    got = [kernel(*args[:-1]) for args in calls]         # keep_bits
    err, plain_ms, uncertified = 0, 0.0, 0
    scoring = calls[0][6:9]
    for batch in batches:
        P = max(calls[c][0].shape[1] for c, _b, _lp, _w in batch)
        T = max(calls[c][1].shape[1] for c, _b, _lp, _w in batch)
        width = max(w for _c, _b, _lp, w in batch)
        dev = calls[0][0].device
        pat = torch.zeros((len(batch), P), dtype=torch.uint8, device=dev)
        txt = torch.zeros((len(batch), T), dtype=torch.uint8, device=dev)
        for r, (c, b, _lp, _w) in enumerate(batch):
            pat[r, :calls[c][0].shape[1]] = calls[c][0][b]
            txt[r, :calls[c][1].shape[1]] = calls[c][1][b]
        pick = lambda k: torch.stack([calls[c][k][b]
                                      for c, b, _lp, _w in batch])
        want, t = timed(lambda: plain(pat, txt, pick(2), pick(3), pick(4),
                                      width, *scoring))
        plain_ms += t
        uncertified += int((~want[4]).sum())
        for r, (c, b, lp, w) in enumerate(batch):
            score, bits, runs, n_runs, certified = (x[b] for x in got[c])
            n = int(n_runs)
            err = max(err, max_abs_err(
                (score, n_runs, certified, runs[:n], bits[:lp + 1]),
                (want[0][r], want[3][r], want[4][r], want[2][r, :n],
                 want[1][r, :lp + 1, :w])))
            if bool(want[1][r, :, w:].any()) or bool(want[2][r, n:].any()) \
                    or bool(runs[n:].any()) or bool(bits[lp + 1:].any()):
                raise AssertionError("a band problem's outputs are not "
                                     "empty beyond its own rows and lanes")
    return err, plain_ms, len(problems), len(batches), uncertified


def replay_e2e(k, full_calls, band_calls):
    """Both e2e classes on a path's calls: each call timed as the path
    made it (no bits kept) and held with its bits kept, the full-matrix
    calls one by one, the band calls through `hold_band`. Returns
    (max_abs_err, kernel ms, plain ms, numbers by class)."""
    e2e = k["module"]
    if any(scoring != band_calls[0][6:9]
           for scoring in (a[6:9] for a in band_calls)):
        raise AssertionError("band calls of one path differ in scoring")
    from trgt_tpu_torch.kernels.bucket import bucket

    def was_kernels(args):
        return all((bucket(lp) + 1) * (bucket(lt) + 1) <= PREV_DEVICE_CELLS
                   for lp, lt in zip(args[2].tolist(), args[3].tolist()))

    full_ms = kernel_ms(e2e.e2e_scan, full_calls)
    band_ms = kernel_ms(e2e.e2e_banded, band_calls)
    prev_band = [a for a in band_calls if was_kernels(a)]
    prev_ms = full_ms + kernel_ms(e2e.e2e_banded, prev_band)
    held = [args[:-1] for args in full_calls]
    err, _, plain_ms = compare(e2e.e2e_scan, k["plain"], held)
    n_prob = n_batches = uncertified = 0
    if band_calls:
        band_err, band_plain_ms, n_prob, n_batches, uncertified = hold_band(
            e2e.e2e_banded, k["band_plain"], band_calls)
        err, plain_ms = max(err, band_err), plain_ms + band_plain_ms
    return err, full_ms + band_ms, plain_ms, {
        "full_calls": len(full_calls), "full_ms": full_ms,
        "band_calls": len(band_calls), "band_ms": band_ms,
        "band_problems": n_prob, "band_plain_batches": n_batches,
        "band_uncertified": uncertified, "ms_prev_problems": prev_ms,
        "prev_band_calls": len(prev_band),
        "prev_band_problems": sum(a[0].shape[0] for a in prev_band)}


def replay(path, table, caps, counts):
    """Every kernel launched on `path` against its plain version on the
    inputs the cuda run gave it; {kernel name: numbers of this replay}.
    Time covers every call, and every call is held: the Viterbi calls
    through `hold_rows`, in two batches split at REPLAY_MAX_L positions,
    all else call by call. The
    bound is the run's own counters' (`counts`, kernels/telemetry.py)."""
    from trgt_tpu_torch.kernels import telemetry
    phase(f"replay: the {path} path's kernel inputs, kernel vs plain")
    totals = telemetry.totals(counts)
    out = {}
    for name, k in table.items():
        calls = caps[name].calls
        if not calls and not (name == "e2e" and caps["e2e_band"].calls):
            continue
        kernel = getattr(k["module"], k["fn"])
        t0 = time.perf_counter()
        extra = {}
        if name == "viterbi":
            batches = [(a[0], a[1]) for a in caps["viterbi_batches"].calls]
            if [len(q) for _, q in batches] != [a[0].shape[0] for a in calls]:
                raise AssertionError("the captured Viterbi batches do not "
                                     "pair with the kernel's calls")
            short = [i for i, a in enumerate(calls)
                     if a[0].shape[1] <= REPLAY_MAX_L]
            rest = [i for i in range(len(calls)) if i not in short]
            err, plain_ms = 0, 0.0
            for group in (short, rest):
                if group:
                    err_rows, ms_rows = hold_rows(
                        kernel, k["plain"], [calls[i] for i in group],
                        [batches[i] for i in group])
                    err, plain_ms = max(err, err_rows), plain_ms + ms_rows
            ms = kernel_ms(kernel, calls)
            prev_calls = [a for a in calls if a[0].shape[1] <= PREV_MAX_L]
            extra = {"held_in_plain_batches": [len(short), len(rest)],
                     "ms_prev_calls": kernel_ms(kernel, prev_calls),
                     "prev_calls": len(prev_calls)}
        elif name == "e2e":
            err, ms, plain_ms, extra = replay_e2e(k, calls,
                                                  caps["e2e_band"].calls)
            calls = calls + caps["e2e_band"].calls
        else:
            err, ms, plain_ms = compare(kernel, k["plain"], calls)
        c = totals[name]
        if c["calls"] != len(calls):
            raise AssertionError(f"{name}: {len(calls)} calls captured, "
                                 f"{c['calls']} counted")
        bound, bound_by = telemetry.bound_ms(name, c)
        n_bytes = c.get("bytes_in", 0) + c.get("bytes_out", 0)
        n_ops = telemetry.operations(name, c)
        if name == "e2e":
            # the bound of each class's calls alone
            for cls in ("full", "band"):
                extra[f"{cls}_bound_ms"] = telemetry.bound_ms(
                    f"e2e_{cls}", counts.get(f"e2e_{cls}", {}))[0]
        print(f"{name}: {len(calls)} {path}-path calls timed and held "
              f"against the plain version in "
              f"{time.perf_counter() - t0:.1f} s: max_abs_err {err} "
              f"(tolerance 0), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound:.6f} ms by {bound_by} ({n_bytes} bytes, "
              f"{n_ops:.0f} operations)", flush=True)
        if name == "e2e":
            print(f"e2e: {extra['full_calls']} full-matrix calls "
                  f"{extra['full_ms']:.3f} ms (bound "
                  f"{extra['full_bound_ms']:.6f}), {extra['band_calls']} "
                  f"band calls {extra['band_ms']:.3f} ms (bound "
                  f"{extra['band_bound_ms']:.6f}), their "
                  f"{extra['band_problems']} problems held against "
                  f"{extra['band_plain_batches']} plain batches, "
                  f"{extra['band_uncertified']} of them uncertified; kernel "
                  f"{extra['ms_prev_problems']:.3f} ms over the full-matrix "
                  f"calls and the {extra['prev_band_calls']} band calls "
                  f"({extra['prev_band_problems']} problems) that hold only "
                  f"problems up to {PREV_DEVICE_CELLS} bucketed cells",
                  flush=True)
        elif extra:
            print(f"viterbi: the {len(short)} calls up to and the "
                  f"{len(rest)} over {REPLAY_MAX_L} positions held row by row "
                  f"against two plain batches of their rows, none left "
                  f"unheld; kernel "
                  f"{extra['ms_prev_calls']:.3f} ms over the "
                  f"{extra['prev_calls']} calls up to {PREV_MAX_L} "
                  f"positions", flush=True)
        if err != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version on the {path} path's inputs")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "library_ms": None, "timed_calls": len(calls),
                     "held_calls": len(calls), **extra}
    return out


def phase_paths():
    from trgt_tpu_torch.utils.synth import cached_hetero_dataset
    phase(f"wgs path: bench{N_LOCI} catalog, --device cuda vs host")
    t0 = time.perf_counter()
    dsdir = cached_hetero_dataset(N_LOCI, seed=SEED, tag=f"bench{N_LOCI}",
                                  root=DATA_ROOT)
    print(f"dataset {os.path.relpath(dsdir, REPO)} ready in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"card: {gpu_name_power()}")
    table = kernel_table()
    wgs_launches, counts, caps = drive_path(dsdir, "reads.bam", "wgs",
                                            ("flank", "viterbi", "e2e"))
    wgs = replay("wgs", table, caps, counts)
    del caps

    phase(f"targeted path: bench{N_LOCI} catalog, every second read rq "
          f"0.85, --preset targeted, --device cuda vs host")
    reads = low_quality_reads(dsdir)
    launches, counts, caps = drive_path(dsdir, reads, "targeted",
                                        tuple(table))
    targeted = replay("targeted", table, caps, counts)

    kernels = []
    for name, k in table.items():
        entry = {"name": name, "route": "cuda", "source": k["source"],
                 "replaces": k["replaces"], "launches": launches[name],
                 **targeted[name]}
        if "also_replaces" in k:
            entry["also_replaces"] = k["also_replaces"]
        if name == "e2e":
            entry["band_launches"] = launches["e2e_band"]
        if name in wgs:
            entry["wgs_path"] = {"launches": wgs_launches[name], **wgs[name]}
            if name == "e2e":
                entry["wgs_path"]["band_launches"] = wgs_launches["e2e_band"]
        kernels.append(entry)
    return kernels, dsdir


# CRAM input: the longest allele's locus and seven with read errors
CRAM_LOCI = 8


def pick_cram_loci(dsdir: str):
    """The locus of the longest allele and seven whose reads carry errors
    (so that spans miss the exact path), spread over allele lengths."""
    with open(os.path.join(dsdir, "truth.json")) as fh:
        truth = json.load(fh)
    by_len = sorted(truth, key=lambda k: (max(truth[k]["alleles"]), k))
    noisy = [k for k in by_len[:-1] if truth[k]["error_rate"] > 0]
    step = len(noisy) / (CRAM_LOCI - 1)
    return [by_len[-1]] + [noisy[int(i * step)] for i in range(CRAM_LOCI - 1)]


def write_cram_subset(dsdir: str, ids):
    """The catalog lines and reads of the loci `ids`: the reads once as
    an indexed BAM and once as a CRAM by the port's CramWriter. Returns
    (catalog, BAM, CRAM, reads, bases, CRAM-writing seconds)."""
    from trgt_tpu_torch.io.bam import BamReader
    from trgt_tpu_torch.io.bam_write import BamWriter
    from trgt_tpu_torch.io.cram_write import CramWriter
    ids = set(ids)
    with open(os.path.join(dsdir, "repeats.bed")) as fh:
        lines = [line for line in fh
                 if line.split("\t")[3].split(";")[0][3:] in ids]
    with open(os.path.join(dsdir, "cram_subset.bed"), "w") as fh:
        fh.write("".join(lines))
    src = BamReader(os.path.join(dsdir, "reads.bam"))
    bam = BamWriter(os.path.join(dsdir, "cram_subset.bam"), src.header.text,
                    src.header.references, build_index=True)
    t0 = time.perf_counter()
    cram = CramWriter(os.path.join(dsdir, "cram_subset.cram"),
                      src.header.text, src.header.references,
                      os.path.join(dsdir, "ref.fasta"))
    t_cram = time.perf_counter() - t0
    n_reads = n_bases = 0
    for rec in src:
        if rec.qname.rsplit("_read", 1)[0] not in ids:
            continue
        aux = [(tag, "f" if isinstance(v, float) else "i"
                if isinstance(v, int) else "B" if isinstance(v, tuple)
                else "Z", v) for tag, v in rec.aux().items()]
        args = (rec.qname, rec.flag, rec.ref_id, rec.pos, rec.mapq,
                rec.cigar, rec.seq, rec.qual, aux)
        bam.write_record(*args)
        t0 = time.perf_counter()
        cram.write_record(*args)
        t_cram += time.perf_counter() - t0
        n_reads += 1
        n_bases += len(rec.seq)
    bam.close()
    t0 = time.perf_counter()
    cram.close()
    t_cram += time.perf_counter() - t0
    if len(lines) != len(ids) or not n_reads:
        raise AssertionError("the CRAM subset lacks loci or reads")
    return ("cram_subset.bed", "cram_subset.bam", "cram_subset.cram",
            n_reads, n_bases, t_cram)


def phase_cram(dsdir: str):
    """`genotype --preset wgs --device cuda` of CRAM input: flank, Viterbi
    and e2e launched; VCF records equal those of the same reads from a
    BAM under --device cuda and --device host, and the CRAM's cuda run
    equals its host run, spanning BAM included. Returns the launches."""
    ids = pick_cram_loci(dsdir)
    phase(f"CRAM input: {CRAM_LOCI} bench{N_LOCI} loci ({ids[0]}, the "
          f"longest allele, and seven with read errors), --device cuda vs "
          f"BAM")
    bed, bam, cram, n_reads, n_bases, t_cram = write_cram_subset(dsdir, ids)
    print(f"CramWriter: {n_reads} reads, {n_bases} bases of loci "
          f"{','.join(ids)} in {t_cram:.3f} s, "
          f"{os.path.getsize(os.path.join(dsdir, cram))} bytes "
          f"(the same reads as BAM: "
          f"{os.path.getsize(os.path.join(dsdir, bam))} bytes)")
    from trgt_tpu_torch.kernels import telemetry
    telemetry.clear()
    runs = {"cram_cuda": run_genotype(dsdir, cram, DEVICE, "wgs", bed,
                                      "smoke_cram_cuda", CRAM_LOCI)}
    launches = launch_counts(telemetry.snapshot())
    del launches["e2e_band"]
    print(f"kernel launches in the CRAM cuda run: {json.dumps(launches)}")
    for name in ("flank", "viterbi", "e2e"):
        if launches[name] <= 0:
            raise AssertionError(f"the {name} kernel was never launched on "
                                 f"CRAM input")
    for name, reads, device in (("bam_cuda", bam, DEVICE),
                                ("bam_host", bam, "host"),
                                ("cram_host", cram, "host")):
        runs[name] = run_genotype(dsdir, reads, device, "wgs", bed,
                                  f"smoke_{name}", CRAM_LOCI)
    got = {name: records(prefix) for name, prefix in runs.items()}
    n_rec = sum(1 for line in got["cram_cuda"][0].splitlines()
                if not line.startswith("#"))
    same_vcf = {name: got[name][0] == got["cram_cuda"][0] for name in got}
    print(f"CRAM records: {n_rec} VCF; VCF equal to {json.dumps(same_vcf)}; "
          f"spanning BAM of the CRAM cuda run equal to its host run "
          f"{got['cram_cuda'][1] == got['cram_host'][1]}")
    if n_rec != CRAM_LOCI or not all(same_vcf.values()) or \
            got["cram_cuda"][1] != got["cram_host"][1]:
        raise AssertionError("genotype of CRAM input differs from the BAM "
                             "runs or from its host run")
    return launches


FLOAT_FIELDS = ("AP", "AM")


def record_key(rec):
    """A merged VcfRecord as a comparable tuple: BCF keeps AP and AM as
    float32 and prints them shorter, so those compare as float32."""
    def f32(tok):
        if tok in (".", ""):
            return tok
        return struct.unpack("<f", struct.pack("<f", float(tok)))[0]
    samples = [tuple((k, tuple(f32(t) for t in v.split(","))
                      if k in FLOAT_FIELDS else v) for k, v in d.items())
               for d in rec.samples]
    return (rec.chrom, rec.pos, rec.id, tuple(rec.alleles), rec.info,
            tuple(rec.fmt_keys), tuple(samples))


def read_records(path: str):
    from trgt_tpu_torch.merge.vcf_text import VcfTextReader
    reader = VcfTextReader(path)
    return reader, [record_key(rec) for contig, _len in reader.contigs()
                    for rec in reader.records(contig)]


def check_bcf_equals_vcf(vcf: str, bcf: str) -> int:
    """The BCF read back through the port's VcfTextReader equals the VCF:
    samples, header lines (but ##trgtCommand=, each run's own arguments)
    and every record. Returns the record count."""
    vcf_reader, vcf_recs = read_records(vcf)
    bcf_reader, bcf_recs = read_records(bcf)

    def header(reader):
        return [line for line in reader.header_lines
                if not line.startswith("##trgtCommand=")]
    if vcf_reader.samples != bcf_reader.samples or \
            header(vcf_reader) != header(bcf_reader) or vcf_recs != bcf_recs:
        raise AssertionError(f"{bcf} read back differs from {vcf}")
    return len(vcf_recs)


def cli(argv):
    """The port's CLI in this process; raises unless it exits 0."""
    from trgt_tpu_torch.cli import main
    rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"trgt_tpu_torch {' '.join(argv[:1])} exited "
                           f"{rc}")


def check_merged_columns(merged: str, inputs) -> int:
    """Sample k of every merged record carries input k's FORMAT fields,
    its GT naming the same allele sequences. Returns the record count."""
    from trgt_tpu_torch.merge.vcf_text import VcfTextReader
    reader = VcfTextReader(merged)
    ins = [VcfTextReader(p) for p in inputs]
    n = 0
    for contig, _len in reader.contigs():
        by_pos = [{r.pos: r for r in x.records(contig)} for x in ins]
        for rec in reader.records(contig):
            n += 1
            for k, sites in enumerate(by_pos):
                src, got = sites[rec.pos], rec.samples[k]
                want = src.samples[0]
                if {f: v for f, v in got.items() if f != "GT"} != \
                        {f: v for f, v in want.items() if f != "GT"}:
                    raise AssertionError(f"sample {k} of {contig}:"
                                         f"{rec.pos + 1} differs from its "
                                         f"input")
                named = [None if i == "." else rec.alleles[int(i)]
                         for i in got["GT"].replace("|", "/").split("/")]
                own = [None if i == "." else src.alleles[int(i)]
                       for i in want["GT"].replace("|", "/").split("/")]
                if named != own:
                    raise AssertionError(f"GT of sample {k} at {contig}:"
                                         f"{rec.pos + 1} names other alleles")
    return n


PLOT_TWO_MOTIF = "HET73"


def phase_commands(dsdir: str):
    """merge, plot and validate through the port's CLI on the outputs of
    the --device cuda runs of phases 7 and 8."""
    phase("commands on the cuda outputs: merge, plot, validate")
    print(f"PIL importable: "
          f"{importlib.util.find_spec('PIL') is not None} (PNG is held in "
          f"the CPU tests only)")
    inputs = [os.path.join(dsdir, f"smoke_{preset}_{DEVICE}.vcf.gz")
              for preset in ("wgs", "targeted")]
    sizes = {}
    for ext in ("vcf.gz", "bcf"):
        out = os.path.join(dsdir, f"smoke_merged.{ext}")
        t0 = time.perf_counter()
        cli(["merge", "--vcf", *inputs, "--force-samples", "-o", out])
        sizes[ext] = (os.path.getsize(out), time.perf_counter() - t0)
    vcf, bcf = (os.path.join(dsdir, f"smoke_merged.{ext}")
                for ext in ("vcf.gz", "bcf"))
    n_sites = check_merged_columns(vcf, inputs)
    n_bcf = check_bcf_equals_vcf(vcf, bcf)
    print(f"merge --force-samples of the wgs and targeted cuda VCFs: "
          f"{n_sites} sites, each sample column == its input's FORMAT "
          f"fields; .vcf.gz {sizes['vcf.gz'][0]} bytes in "
          f"{sizes['vcf.gz'][1]:.3f} s, .bcf {sizes['bcf'][0]} bytes in "
          f"{sizes['bcf'][1]:.3f} s, read back == the VCF ({n_bcf} records)")
    if n_sites != N_LOCI:
        raise AssertionError(f"{n_sites} merged sites, expected {N_LOCI}")

    ids = pick_cram_loci(dsdir)[0], PLOT_TWO_MOTIF
    prefix = os.path.join(dsdir, f"smoke_wgs_{DEVICE}")
    for tr_id in ids:
        for plot_type in ("allele", "waterfall"):
            for ext in ("svg", "pdf"):
                out = os.path.join(dsdir, f"smoke_{tr_id}_{plot_type}.{ext}")
                t0 = time.perf_counter()
                cli(["plot", "--genome", os.path.join(dsdir, "ref.fasta"),
                     "--repeats", os.path.join(dsdir, "repeats.bed"),
                     "--vcf", prefix + ".vcf.gz",
                     "--spanning-reads", prefix + ".spanning.bam",
                     "--repeat-id", tr_id, "--image", out,
                     "--plot-type", plot_type])
                seconds = time.perf_counter() - t0
                with open(out, "rb") as fh:
                    data = fh.read()
                if ext == "svg":
                    import xml.etree.ElementTree as ET
                    ET.fromstring(data)
                elif not data.startswith(b"%PDF-"):
                    raise AssertionError(f"{out} is not a PDF")
                print(f"plot {tr_id} {plot_type} .{ext}: {len(data)} bytes "
                      f"in {seconds:.3f} s")

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli(["validate", "--genome", os.path.join(dsdir, "ref.fasta"),
             "--repeats", os.path.join(dsdir, "repeats.bed")])
    last = out.getvalue().splitlines()[-1]
    print(f"validate bench{N_LOCI} in {time.perf_counter() - t0:.3f} s: "
          f"{last}")
    if last != f"Validation successful. Loci pass = {N_LOCI}":
        raise AssertionError("validate did not pass every bench96 locus")


# merge at scale: samples x sites a sample
MERGE_SAMPLES = 8
MERGE_SITES = 10_000
MERGE_MOTIFS = ("CAG", "AT", "GGC", "AAAG", "T", "CCATTTAGG", "AATGG")


def write_cohort(dsdir: str, header_vcf: str, seed: int = 23):
    """MERGE_SAMPLES single-sample VCFs of MERGE_SITES sites each (BGZF,
    the port's BgzfWriter), under the header of `header_vcf`: three fifths
    of the sites shared by all samples, the rest drawn per sample from a
    pool; REF fixed by site, ALT alleles, genotype and FORMAT values per
    sample. Returns (paths, number of distinct sites)."""
    from trgt_tpu_torch.io.bgzf import BgzfReader, BgzfWriter
    header = [line for line in BgzfReader(header_vcf).read_all().decode()
              .splitlines() if line.startswith("#")]
    contig = next(line for line in header if line.startswith("##contig="))
    chrom = contig.split("ID=")[1].split(",")[0]
    length = int(contig.split("length=")[1].rstrip(">"))
    rng = random.Random(seed)
    n_shared = MERGE_SITES * 3 // 5
    n_pool = MERGE_SITES * 7 // 5
    step = length // (n_pool + 1)
    sites = []
    for i in range(n_pool):
        motif = MERGE_MOTIFS[i % len(MERGE_MOTIFS)]
        sites.append((step * (i + 1), motif,
                      rng.choice("ACGT") + motif * (3 + i % 9)))
    shared, pool = sites[:n_shared], sites[n_shared:]
    paths, used = [], set()
    for s in range(MERGE_SAMPLES):
        mine = sorted(shared + rng.sample(pool, MERGE_SITES - n_shared))
        used.update(pos for pos, _m, _r in mine)
        lines = header[:-1] + [header[-1].rsplit("\t", 1)[0]
                               + f"\tsample{s}"]
        for pos, motif, ref in mine:
            copies = sorted({rng.randint(1, 14) for _ in range(2)})
            alts = [ref[0] + motif * c for c in copies]
            alts = [a for a in alts if a != ref]
            if not alts:
                gt, alleles = "0/0", [ref, ref]
            elif len(alts) == 1:
                gt = rng.choice(["0/1", "1/1"])
                alleles = [ref if g == "0" else alts[0]
                           for g in gt.split("/")]
            else:
                gt, alleles = "1/2", alts
            lens = [len(a) - 1 for a in alleles]
            am = rng.choice([".,.", f"{rng.random():.2f},"
                                    f"{rng.random():.2f}"])
            lines.append(
                f"{chrom}\t{pos}\t.\t{ref}\t{','.join(alts) or '.'}\t.\t.\t"
                f"TRID=M{pos};END={pos + len(ref) - 1};MOTIFS={motif};"
                f"STRUC=<TR>\tGT:AL:ALLR:SD:MC:MS:AP:AM\t{gt}:"
                f"{lens[0]},{lens[1]}:{lens[0]}-{lens[0]},{lens[1]}-"
                f"{lens[1]}:{rng.randint(3, 40)},{rng.randint(3, 40)}:"
                f"{lens[0] // len(motif)},{lens[1] // len(motif)}:"
                f"0(0-{lens[0]}),0(0-{lens[1]}):1.000000,"
                f"{rng.random():.6f}:{am}")
        path = os.path.join(dsdir, f"cohort_sample{s}.vcf.gz")
        w = BgzfWriter(path)
        w.write(("\n".join(lines) + "\n").encode())
        w.close()
        paths.append(path)
    return paths, len(used)


# runs `python -m trgt_tpu_torch merge <argv>` and prints its exit code,
# seconds and peak RSS. A child forked from this process would report this
# process's RSS (CUDA context included) as its own high-water mark, so the
# merge is the only child of a small interpreter that reads
# getrusage(RUSAGE_CHILDREN) after it.
_MERGE_CHILD = r"""
import resource, subprocess, sys, time
t0 = time.perf_counter()
rc = subprocess.run([sys.executable, "-m", "trgt_tpu_torch", "merge",
                     *sys.argv[1:]]).returncode
seconds = time.perf_counter() - t0
print(rc, seconds, resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss)
"""


def merge_child(args):
    """`python -m trgt_tpu_torch merge ...` in a child process; returns
    (seconds, peak RSS in MiB)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _MERGE_CHILD, *args],
                         cwd=REPO, env=env, check=True,
                         stdout=subprocess.PIPE, text=True).stdout.split()
    rc, seconds, max_rss_kib = int(out[0]), float(out[1]), int(out[2])
    if rc != 0:
        raise RuntimeError(f"merge exited {rc}")
    return seconds, max_rss_kib / 1024


def phase_merge_scale(dsdir: str):
    phase(f"merge at scale: {MERGE_SAMPLES} samples x {MERGE_SITES} sites "
          f"(a cohort of hundreds of samples over ~10^6 loci, cut to fit "
          f"the script's time)")
    t0 = time.perf_counter()
    paths, n_union = write_cohort(
        dsdir, os.path.join(dsdir, f"smoke_wgs_{DEVICE}.vcf.gz"))
    print(f"wrote {len(paths)} VCFs of {MERGE_SITES} sites ({n_union} "
          f"distinct) in {time.perf_counter() - t0:.3f} s")
    out = {}
    for out_type, ext in (("z", "vcf.gz"), ("b", "bcf")):
        target = os.path.join(dsdir, f"cohort_merged.{ext}")
        seconds, rss = merge_child(["--vcf", *paths, "-o", target,
                                    "-O", out_type])
        out[ext] = target
        print(f"merge -O {out_type}: {seconds:.3f} s, peak RSS {rss:.1f} "
              f"MiB, {os.path.getsize(target)} bytes", flush=True)
    t0 = time.perf_counter()
    n = check_bcf_equals_vcf(out["vcf.gz"], out["bcf"])
    print(f"merged records {n} == distinct sites {n_union}; BCF read back "
          f"== the VCF ({time.perf_counter() - t0:.3f} s)")
    if n != n_union:
        raise AssertionError(f"{n} merged records, {n_union} distinct sites")


def bam_records(data: bytes):
    """The length-prefixed records of BAM bytes after the header."""
    out, off = [], 0
    while off < len(data):
        (size,) = struct.unpack_from("<i", data, off)
        out.append(data[off:off + 4 + size])
        off += 4 + size
    return out


def genotype_child(dsdir: str, reads: str, preset: str, name: str,
                   threads: int, extra=()):
    """`python -m trgt_tpu_torch -vv genotype ... -t N --device cuda` in a
    child process, as a user runs it. Returns (prefix, wall seconds, the
    workers' debug lines: {worker: {"ready": s, "done": s, "loci": n,
    "stages": {...}, "kernels": telemetry snapshot}}, and with N > 1 the
    parent's `pool_timeline`)."""
    prefix = os.path.join(dsdir, name)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "trgt_tpu_torch", "-vv", "genotype",
           "--genome", os.path.join(dsdir, "ref.fasta"),
           "--repeats", os.path.join(dsdir, "repeats.bed"),
           "--reads", os.path.join(dsdir, reads), "--preset", preset,
           "--output-prefix", prefix, "--device", DEVICE, "-t",
           str(threads), *extra]
    epoch, t0 = time.time(), time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"genotype -t {threads} exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return (prefix, wall, worker_lines(proc.stderr, threads),
            pool_timeline(proc.stderr, epoch, wall) if threads > 1 else None)


def worker_lines(stderr: str, threads: int):
    """The `-t N` workers' debug lines of a `-vv` run's stderr: {worker:
    {"ready": s, "done": s, "loci": n, "stages": {...}, "kernels":
    telemetry snapshot}}, the seconds counted from its spawn."""
    workers = {}
    for line in stderr.splitlines():
        m = re.match(r"\[worker (\d+)\] DEBUG worker ready ([\d.]+) s",
                     line)
        if m:
            workers.setdefault(int(m[1]), {})["ready"] = float(m[2])
        m = re.match(r"\[worker (\d+)\] DEBUG worker done ([\d.]+) s after "
                     r"spawn: (\d+) loci, stages (\{.*?\}), kernels "
                     r"(\{.*\})$", line)
        if m:
            workers.setdefault(int(m[1]), {}).update(
                done=float(m[2]), loci=int(m[3]), stages=json.loads(m[4]),
                kernels=json.loads(m[5]))
    if threads > 1 and (len(workers) != threads or any(
            "done" not in w for w in workers.values())):
        raise AssertionError(f"-t {threads}: the workers' debug lines are "
                             f"missing ({sorted(workers)})")
    return workers


def pool_timeline(stderr: str, t0: float, wall: float):
    """Where the wall of a `-vv genotype -t N` child went, from the
    parent's `worker pool:` line (the spawn's epoch, the last end-of-stream
    and the last worker exit after it) and `t0`, the epoch at which the
    child was started: {"parent_start": s before the spawn, "eos": s,
    "exit": s after the spawn, "parent_end": s after the last exit}."""
    m = re.search(r"worker pool: \d+ workers spawned at ([\d.]+) \(epoch\); "
                  r"the last end-of-stream ([\d.]+) s and the last exit "
                  r"([\d.]+) s after", stderr)
    if not m:
        raise AssertionError("the parent's worker pool line is missing")
    start = float(m[1]) - t0
    eos, exit_ = float(m[2]), float(m[3])
    return {"parent_start": round(start, 3), "eos": eos, "exit": exit_,
            "parent_end": round(wall - start - exit_, 3)}


POOL_THREADS = (1, 2, 4)


def phase_pool():
    """A catalog of the bench generator with POOL_MIN_LOCI loci a worker
    at -t 4 (smaller ones run on threads), under both presets with `-t
    1/2/4 --device cuda`, each a child process: -t 2 and -t 4 write the
    records of -t 1, every worker that wrote a record launched the Viterbi
    kernel, and the workers together launched every kernel of the path.
    Returns the targeted -t 4 workers' launches."""
    from trgt_tpu_torch.engine.runner import POOL_MIN_LOCI
    from trgt_tpu_torch.utils.synth import cached_hetero_dataset
    n_loci = POOL_MIN_LOCI * POOL_THREADS[-1]
    phase(f"worker pool: bench{n_loci}, -t {'/'.join(map(str, POOL_THREADS))}"
          f" --device cuda, wgs and targeted")
    dsdir = cached_hetero_dataset(n_loci, seed=SEED, tag=f"bench{n_loci}",
                                  root=DATA_ROOT)
    paths = {"wgs": ("reads.bam", ("flank", "viterbi", "e2e")),
             "targeted": (low_quality_reads(dsdir),
                          ("flank", "viterbi", "editdist", "e2e"))}
    pool_launches = None
    for preset, (reads, expect) in paths.items():
        runs = {t: genotype_child(dsdir, reads, preset,
                                  f"smoke_pool_{preset}_t{t}", t)
                for t in POOL_THREADS}
        want = records(runs[1][0])
        walls = {t: round(r[1], 3) for t, r in runs.items()}
        print(f"{preset}: walls of the child process (torch import, CUDA "
              f"contexts and worker start-up included) {json.dumps(walls)}"
              f" s; loci/s " + json.dumps(
                  {t: round(n_loci / w, 3) for t, w in walls.items()}))
        for t in POOL_THREADS[1:]:
            same = records(runs[t][0]) == want
            workers = runs[t][2]
            print(f"{preset} -t {t}: records == -t 1 {same}; per worker "
                  f"(loci, ready s, done s): " + json.dumps(
                      {w: (v["loci"], v.get("ready"), v["done"])
                       for w, v in sorted(workers.items())})
                  + f"; the parent (s) {json.dumps(runs[t][3])}")
            if not same:
                raise AssertionError(f"-t {t} records differ from -t 1 "
                                     f"({preset})")
            launched = {}
            for w, v in sorted(workers.items()):
                counts = launch_counts(v["kernels"])
                print(f"  worker {w} launches {json.dumps(counts)}")
                if v["loci"] and not counts["viterbi"]:
                    raise AssertionError(f"worker {w} wrote records without "
                                         f"a Viterbi launch")
                for name, n in counts.items():
                    launched[name] = launched.get(name, 0) + n
            missing = [name for name in expect if not launched[name]]
            if missing:
                raise AssertionError(f"-t {t} {preset}: no worker launched "
                                     f"{missing}")
            if preset == "targeted" and t == POOL_THREADS[-1]:
                pool_launches = launched
    return pool_launches


def phase_mesh(dsdir: str):
    """`engine.sharding.dryrun(2, "cuda")` over [cuda:0, cuda:0], then
    bench96 wgs under that mesh: the records of phase 7, with flank,
    Viterbi and e2e launched on both shards."""
    import torch
    from trgt_tpu_torch import mesh
    from trgt_tpu_torch.engine.sharding import dryrun
    phase("mesh: [cuda:0, cuda:0], the dry run and bench96 wgs")
    if os.environ.pop("TRGT_TPU_MESH", None) is not None:
        print("TRGT_TPU_MESH was set; unset for this phase")
    t0 = time.perf_counter()
    dryrun(2, DEVICE)
    print(f"sharding.dryrun(2, {DEVICE!r}): the VCF body over the mesh == "
          f"--device host ({time.perf_counter() - t0:.1f} s)")
    from trgt_tpu_torch.kernels import telemetry
    dev = torch.device(DEVICE, 0)
    mesh.set_mesh([dev, dev])
    try:
        telemetry.clear()
        prefix = run_genotype(dsdir, "reads.bam", DEVICE, "wgs",
                              name="smoke_wgs_mesh")
        launches = launch_counts(telemetry.snapshot())
        shards = telemetry.by_shard()
        installed = mesh.current_mesh()
    finally:
        mesh.disable_mesh()
    by_shard = {name: [launch_counts(shards.get(k, {}))[name]
                       for k in range(2)] for name in launches}
    same = records(prefix) == records(
        os.path.join(dsdir, f"smoke_wgs_{DEVICE}"))
    print(f"bench{N_LOCI} wgs under the mesh {installed}: records == the "
          f"run without the mesh {same}; launches by shard "
          f"{json.dumps(by_shard)}; the wrappers' launches "
          f"{json.dumps(launches)}")
    if not same or installed != [dev, dev]:
        raise AssertionError("the mesh run differs from the run without it")
    for name, per_shard in by_shard.items():
        if sum(per_shard) != launches[name]:
            raise AssertionError(f"{name}: {per_shard} launches by shard, "
                                 f"{launches[name]} in all")
    for name in ("flank", "viterbi", "e2e"):
        if not all(by_shard[name]):
            raise AssertionError(f"{name} was not launched on both shards")
    return by_shard


PLOIDY_CASES = (
    ("haploid", "chrX", ("X1", "CAG", 10, (14, 14)), ["--karyotype", "XY"],
     "1"),
    ("zero_ploidy", "chrY", ("Y1", "CAG", 10, (10, 10)), [], "./."),
)


def phase_ploidy_shards(dsdir: str):
    """Under --device cuda and host: a haploid chrX locus under
    --karyotype XY and a zero-ploidy chrY locus (equal records, the
    expected GT); a 3-way --shard-index/--shard-count split of bench96
    wgs whose records together are phase 7's."""
    from trgt_tpu_torch.kernels import telemetry
    from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset
    phase("karyotype and catalog shards under --device cuda")
    for name, chrom, locus, extra, gt in PLOIDY_CASES:
        d = os.path.join(DATA_ROOT, f"smoke_{name}")
        os.makedirs(d, exist_ok=True)
        make_dataset(d, [SynthLocus(*locus)], depth=10, chrom=chrom,
                     error_rate=0.01)
        telemetry.clear()
        got = {device: records(run_genotype(
            d, "reads.bam", device, "wgs", name=f"out_{device}", n_loci=1,
            extra=extra)) for device in (DEVICE, "host")}
        launches = launch_counts(telemetry.snapshot())
        line = got[DEVICE][0].splitlines()[-1].split("\t")
        sample = dict(zip(line[8].split(":"), line[9].split(":")))
        print(f"{name} ({chrom} {' '.join(extra) or '--karyotype XX'}): GT "
              f"{sample['GT']}, cuda == host {got[DEVICE] == got['host']}; "
              f"launches {json.dumps(launches)}")
        if got[DEVICE] != got["host"] or sample["GT"] != gt:
            raise AssertionError(f"{name}: GT {sample['GT']} (want {gt}) or "
                                 f"cuda != host")
    full_vcf, full_bam = records(os.path.join(dsdir, "smoke_wgs_host"))
    lines, recs = [], []
    for k in range(3):
        vcf, bam = records(run_genotype(
            dsdir, "reads.bam", DEVICE, "wgs", name=f"smoke_shard{k}",
            n_loci=N_LOCI // 3, extra=["--shard-index", str(k),
                                       "--shard-count", "3"]))
        lines += vcf.splitlines()[1:]
        recs += bam_records(bam)
    want = full_vcf.splitlines()[1:]
    same = sorted(lines) == sorted(want) and \
        sorted(recs) == sorted(bam_records(full_bam))
    print(f"3 catalog shards under cuda: {len(lines)} VCF records, "
          f"{len(recs)} BAM records; together == the unsharded host run "
          f"{same}")
    if not same or len(lines) != N_LOCI:
        raise AssertionError("the catalog shards do not add up to the "
                             "unsharded run")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    phase_env()
    for fn in (phase_build, phase_flank, phase_viterbi, phase_editdist,
               phase_e2e_fuzz):
        t0 = time.perf_counter()
        fn()
        print(f"   ({time.perf_counter() - t0:.1f} s)")
    kernels, dsdir = phase_paths()
    t_new = time.perf_counter()
    t0 = time.perf_counter()
    cram_launches = phase_cram(dsdir)
    print(f"   ({time.perf_counter() - t0:.1f} s)")
    for entry in kernels:
        entry["cram_path"] = {"launches": cram_launches[entry["name"]]}
    for fn in (phase_commands, phase_merge_scale):
        t0 = time.perf_counter()
        fn(dsdir)
        print(f"   ({time.perf_counter() - t0:.1f} s)")
    print(f"CRAM, commands and merge-at-scale phases: "
          f"{time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    t0 = time.perf_counter()
    pool_launches = phase_pool()
    print(f"   ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    mesh_launches = phase_mesh(dsdir)
    print(f"   ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_ploidy_shards(dsdir)
    print(f"   ({time.perf_counter() - t0:.1f} s)")
    for entry in kernels:
        entry["pool_path"] = {"launches": pool_launches[entry["name"]]}
        entry["mesh_path"] = {"launches_by_shard":
                              mesh_launches[entry["name"]]}
    print(f"worker pool, mesh, karyotype and shard phases: "
          f"{time.perf_counter() - t_new:.1f} s")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(gpu_name_power())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
