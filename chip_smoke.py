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
                  under --preset wgs as child processes `python -m
                  trgt_tpu_torch -vv genotype -t 1/2/4 --device cuda`:
                  -t 2 and -t 4 write the records of -t 1, every
                  worker that wrote a record launched Viterbi (its
                  counters, logged at debug level), and the workers
                  together launched every kernel of the path; the walls
                  (the targeted preset's pool is phase 18's)
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
 22. cluster      (run after 14) two child processes `genotype --device
                  cuda --preset wgs --shard-count 2 --shard-index k` of
                  the bench catalog, joined through TRGT_COORDINATOR_
                  ADDRESS on a free local port into one gloo group (both
                  on cuda:0): each joined a group of 2 as rank k and
                  launched flank, Viterbi and e2e; the riffled VCF records
                  and the sorted BAM records == phase 7's cuda and host
                  runs. Then the card count and the mesh that a default
                  run in this process installed (none on one card), and,
                  over several cards, a run under the default mesh
                  (records == phase 7's, every card launched the path's
                  kernels)
 15. adversarial  the catalog of tests/test_adversarial_e2e.py (14 loci:
                  homopolymers, stutter, indels at the TR boundaries)
                  under the size and cluster genotypers: cuda == host ==
                  the md5s trgt_tpu --device host gives (pinned below);
                  each cuda run's kernel calls replayed against the plain
                  versions, as in phases 7-8
 16. noisy        20 bench-generator loci, TRs up to 1 kb, read errors
                  5-25 %, under --preset wgs and targeted, and a second
                  such catalog of another seed (targeted) on which
                  trgt_tpu's two Viterbi paths differ (ROADMAP C4):
                  cuda == the md5s of trgt_tpu --device cpu, its device
                  path (float32 Viterbi), the port's --device host ==
                  those of trgt_tpu --device host (float64), and cuda
                  differs from host in as many records as trgt_tpu's two
                  paths do (pinned: 0, and 1 on the second catalog); the
                  kernel calls replayed as in 15
 17. scale        the 10^4-locus catalog of benchmarks/scale10k.py, made by
                  a child process started after phase 11 (it runs beside
                  phases 12-16), genotyped by `python -m trgt_tpu_torch
                  genotype -t 4 --device cuda` as a child process (the
                  worker pool): VCF and BAM md5s == trgt_tpu --device host
                  -t 6's, 10,000 records, the truth AL of every error-free
                  locus; wall, loci/s, peak RSS, nvidia-smi memory.used and
                  utilization, the workers' stage seconds and launches;
                  then the longest and the deepest loci alone in this
                  process: records == the -t 4 run's, their kernel calls
                  (flank texts over a tile, the widest bands) replayed
 18. targeted at  a 2,500-locus catalog of the same generator, every
     scale        second read at rq 0.85 (made beside phases 12-16, like
                  17's), under `genotype --preset targeted -t 4 --device
                  cuda` as a child process: VCF and BAM md5s == trgt_tpu
                  --device host -t 6 --preset targeted's, 2,500 records,
                  truth AL of every error-free locus, every worker that
                  wrote a record launched Viterbi and the workers together
                  all four kernels; wall, loci/s, launches, edit-distance
                  pairs and cells, the impure filter's reads, busy share
                  and memory.used; then the loci with the most cluster
                  pairs and the longest alleles alone in this process:
                  records == the -t 4 run's, their kernel calls replayed
 19. flags       96 loci of the bench generator, TRs scaled to at most 1
                  kb, under each flag set of tests/test_torch_flags.py
                  (--max-depth 2 and 20, --aln-scoring under both
                  presets, --min-flank-id-frac 0.9, --min-read-quality
                  0.5 on reads of mixed rq, --output-flank-len 10): cuda
                  == host records, every kernel call replayed as in
                  phases 7-8, the reservoir walk, the downsample and the
                  quality filter seen to run; then the catalog as a CRAM
                  (the port's CramWriter) through the -t 2 worker pool
                  under --device cuda: the VCF records of the BAM cuda
                  run and the records of the CRAM host run
 20. bench        `bench_torch.py --cell bench96-wgs --repeats 1` as a
                  child process: its result line correct, on the card,
                  with flank, Viterbi and e2e launched
 21. Viterbi rows the rows of every replayed path's Viterbi calls (phases
                  7-8, 15-19) held against the plain version in a few
                  batches (see below)
Phases 15-18 first check the md5s of the generated repeats.bed and
ref.fasta, so that a generator difference on this machine shows as such.
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
on the number of rows: so each replay keeps its Viterbi calls' kernel
outputs, and phase 21 runs the rows of every path's calls up to a padded
query length of REPLAY_MAX_L as one batch and those of all longer calls as
another (each cut where its traceback words would pass
PLAIN_VITERBI_BYTES), against which each call's kernel output is held row
by row; a path's Viterbi "plain_ms" is the time of the batches that held
its rows ("plain_batches"), which other paths share. The script prints
each phase's seconds and the total. The second-to-last line is
{"kernels": [...]}: one entry per kernel with the targeted path's numbers
and, under "wgs_path", the same numbers of the wgs path, under "cram_path"
the launches of phase 9, under "pool_path" the launches of the targeted
-t 4 workers of phase 18 together, under "mesh_path" the launches of
phase 13 by shard, under "cluster_path" the launches of phase 22 by
rank, and under "adversarial_path", "noisy_path",
"scale_path", "targeted_scale_path" and "flags_path" the launches of
phases 15-19 (the cuda runs of both genotypers, presets or all flag sets
together; the 10^4 and 2,500 runs' workers together) beside the replays'
max_abs_err, held calls and times (those of phases 17-18: of their loci
run alone, whose launches are "replayed_loci_launches"), and under
"flags_pool_path" the launches of phase 19's -t 2 workers. The last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of trgt_tpu.
"""

import collections
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import random
import re
import socket
import struct
import subprocess
import sys
import threading
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
    from trgt_tpu_torch.kernels import e2e
    from trgt_tpu_torch.utils import recorder
    prefix = os.path.join(dsdir, name or f"smoke_{preset}_{device}")
    recorder.STAGE_TIMES.clear()
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
    stages = {k: round(v, 3) for k, v in recorder.STAGE_TIMES.items()}
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


def capture_cuda(dsdir, reads, preset, **kw):
    """`run_genotype` with --device cuda, the inputs of every kernel call
    captured and the counters set to 0 just before and read just after
    (`kw`: run_genotype's name, n_loci, repeats, extra). Returns (prefix,
    launches with e2e_band, the run's counters, captures)."""
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
        prefix = run_genotype(dsdir, reads, DEVICE, preset, **kw)
        counts = telemetry.snapshot()
    launches = launch_counts(counts)
    if launches["e2e_band"] != len(caps["e2e_band"].calls) or \
            launches["e2e"] - launches["e2e_band"] != len(caps["e2e"].calls):
        raise AssertionError("the captured e2e calls do not pair with the "
                             "launch counts")
    for cls, c in counts.items():
        if c.get("calls", 0) != c.get("launches", 0):
            raise AssertionError(f"{cls}: {c.get('calls', 0)} batches "
                                 f"counted, {c.get('launches', 0)} launches")
    return prefix, launches, counts, caps


def drive_path(dsdir, reads, preset, expect):
    """Genotype with --device cuda (`capture_cuda`) and --device host; the
    two must write identical records and every kernel in `expect` must
    have been launched. Returns (launches, the run's counters, captures)."""
    cuda_prefix, launches, counts, caps = capture_cuda(dsdir, reads, preset)
    band_launches = launches.pop("e2e_band")
    print(f"kernel launches in the {preset} cuda run: {json.dumps(launches)}"
          f" (e2e: {band_launches} of them the band class's)")
    print(f"telemetry of the {preset} cuda run: {json.dumps(counts)}")
    host_prefix = run_genotype(dsdir, reads, "host", preset)
    cuda_vcf, cuda_bam = records(cuda_prefix)
    host_vcf, host_bam = records(host_prefix)
    n_rec = sum(1 for line in cuda_vcf.splitlines()
                if not line.startswith("#"))
    pinned = records_md5(cuda_prefix) == RUN_MD5[("bench96", preset, "host")]
    print(f"{preset} records: {n_rec} VCF, {len(cuda_bam)} spanning-BAM "
          f"bytes; VCF equal {cuda_vcf == host_vcf}, BAM equal "
          f"{cuda_bam == host_bam}; == trgt_tpu --device host's md5s "
          f"{pinned}")
    if n_rec != N_LOCI or cuda_vcf != host_vcf or cuda_bam != host_bam \
            or not pinned:
        raise AssertionError(f"cuda and host genotype outputs differ, or "
                             f"differ from trgt_tpu's ({preset})")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"the {name} kernel was never launched on "
                                 f"the {preset} path")
    launches["e2e_band"] = band_launches
    return launches, counts, caps


LOW_RQ_READS = "reads_low_rq.bam"


def low_quality_reads(dsdir: str) -> str:
    """reads.bam with every second read's rq rewritten to 0.85 (under 0.9,
    so the targeted preset's impure-read filter labels it)."""
    return rq_reads(dsdir, LOW_RQ_READS, (0.999, 0.85))


def rq_reads(dsdir: str, name: str, cycle) -> str:
    """reads.bam with read i's rq rewritten to cycle[i % len(cycle)], as
    `name` in the same folder."""
    from trgt_tpu_torch.io.bam import BamReader
    from trgt_tpu_torch.io.bam_write import BamWriter
    src = BamReader(os.path.join(dsdir, "reads.bam"))
    w = BamWriter(os.path.join(dsdir, name), src.header.text,
                  src.header.references, build_index=True)
    for i, rec in enumerate(src):
        w.write_record(rec.qname, rec.flag, rec.ref_id, rec.pos, rec.mapq,
                       rec.cigar, rec.seq, rec.qual,
                       [("rq", "f", cycle[i % len(cycle)])])
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


def hold_rows(plain, gots, batches):
    """The Viterbi kernel's outputs `gots` (one per call, on any device)
    against ONE run of the plain version over all their rows (`batches`:
    each call's hmms and queries): rows do not act on one another, so a
    row's segments are those of its own call, padded with -1 to the
    batch's positions and levels. Holds for rows with a valid path, which
    is every row of a genotype run that ended. Returns (max_abs_err of
    each call, plain ms)."""
    args = dense_calls([([h for hmms, _ in batches for h in hmms],
                         [q for _, queries in batches for q in queries])])[0]
    want, plain_ms = timed(lambda: plain(*args))
    errs, lo = [], 0
    for got in gots:
        got = got.to(want.device)
        L, B, K = got.shape[0] - 1, got.shape[1], got.shape[2]
        rows = want[:, lo:lo + B]
        lo += B
        errs.append(max(max_abs_err(got[:L], rows[:L, :, :K]),
                        max_abs_err(got[L, :, 0], rows[-1, :, 0])))
        if not (bool((rows[L:-1] == -1).all())
                and bool((rows[:L, :, K:] == -1).all())):
            raise AssertionError("the plain batch's rows are not empty "
                                 "beyond a call's positions and levels")
    if lo != want.shape[1]:
        raise AssertionError(f"{lo} rows held, {want.shape[1]} in the batch")
    return errs, plain_ms


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


# the columns of one tile of the flank kernel's block class: a wider text
# is walked tile by tile, its rows' boundaries carried in shared memory
FLANK_TILE = 4096


# {path: call_shapes} of every replay so far
PATH_SHAPES = {}


def call_shapes(caps):
    """The largest shapes among a path's kernel calls: the widest flank
    text and the calls wider than a tile, the longest Viterbi query, and
    the widest band and largest band problem (bytes of direction bits)
    beside the band class's caps."""
    from trgt_tpu_torch.kernels import e2e
    flank = [a[1].shape[1] for a in caps["flank"].calls]
    lanes = bits = 0
    for a in caps["e2e_band"].calls:
        len_p = a[2].long()
        wb = e2e.band_geometry(len_p, a[3].long(), a[4].long())[2]
        lanes = max(lanes, int(wb.max()))
        bits = max(bits, int(((len_p + 1) * wb).max()))
    return {"flank_widest_text": max(flank, default=0),
            "flank_calls_over_a_tile": sum(w > FLANK_TILE for w in flank),
            "viterbi_longest_query": max(
                (a[0].shape[1] for a in caps["viterbi"].calls), default=0),
            "band_widest": lanes, "band_max_width": e2e.MAX_BAND_WIDTH,
            "band_largest_bits": bits, "band_max_bytes": e2e.MAX_BAND_BYTES}


def replay(path, table, caps, counts):
    """Every kernel launched on `path` against its plain version on the
    inputs the cuda run gave it; {kernel name: numbers of this replay}.
    Time covers every call, and every call is held: the Viterbi calls'
    rows after the last phase, with every other path's
    (`hold_viterbi_rows`, which fills in their max_abs_err and plain_ms),
    all else call by call here. The bound is the run's own counters'
    (`counts`, kernels/telemetry.py)."""
    from trgt_tpu_torch.kernels import telemetry
    phase(f"replay: the {path} path's kernel inputs, kernel vs plain")
    PATH_SHAPES[path] = call_shapes(caps)
    print(f"{path} shapes: {json.dumps(PATH_SHAPES[path])}")
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
            # the rows are held after the last phase, with every other
            # path's (`hold_viterbi_rows`); the outputs wait on the host
            pending = {"path": path, "calls": []}
            for args, (hmms, queries) in zip(calls, batches):
                got = kernel(*args)
                if not bool(got[-1].all()):
                    raise AssertionError("a replayed Viterbi row has no "
                                         "valid path")
                pending["calls"].append((got.cpu(), hmms, queries))
            err = plain_ms = None
            ms = kernel_ms(kernel, calls)
            prev_calls = [a for a in calls if a[0].shape[1] <= PREV_MAX_L]
            extra = {"ms_prev_calls": kernel_ms(kernel, prev_calls),
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
        if name == "viterbi":
            held = (f"timed, their rows kept for the plain batches after "
                    f"the last phase, in {time.perf_counter() - t0:.1f} s")
        else:
            held = (f"timed and held against the plain version in "
                    f"{time.perf_counter() - t0:.1f} s: max_abs_err {err} "
                    f"(tolerance 0), plain {plain_ms:.3f} ms")
        print(f"{name}: {len(calls)} {path}-path calls {held}; kernel "
              f"{ms:.3f} ms, bound {bound:.6f} ms by {bound_by} ({n_bytes} "
              f"bytes, {n_ops:.0f} operations)", flush=True)
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
            print(f"viterbi: kernel {extra['ms_prev_calls']:.3f} ms over the "
                  f"{extra['prev_calls']} calls up to {PREV_MAX_L} "
                  f"positions", flush=True)
        if err not in (0, None):
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version on the {path} path's inputs")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "library_ms": None, "timed_calls": len(calls),
                     "held_calls": len(calls), **extra}
        if name == "viterbi":
            pending["entry"] = out[name]
            PENDING_ROWS.append(pending)
    return out


def phase_paths():
    from trgt_tpu_torch.utils.synth import cached_hetero_dataset
    phase(f"wgs path: bench{N_LOCI} catalog, --device cuda vs host")
    t0 = time.perf_counter()
    dsdir = cached_hetero_dataset(N_LOCI, seed=SEED, tag=f"bench{N_LOCI}",
                                  root=DATA_ROOT)
    print(f"dataset {os.path.relpath(dsdir, REPO)} ready in "
          f"{time.perf_counter() - t0:.1f} s")
    check_files(f"bench{N_LOCI}", dsdir)
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

    return {"wgs": (wgs_launches, wgs), "targeted": (launches, targeted)}, \
        dsdir


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


# `python -m trgt_tpu_torch` with runner.POOL_MIN_LOCI set first, so that a
# small catalog runs on the worker pool
_POOL_CHILD = r"""
import sys
from trgt_tpu_torch.engine import runner
runner.POOL_MIN_LOCI = int(sys.argv[1])
from trgt_tpu_torch.cli import main
sys.exit(main(sys.argv[2:]))
"""


def genotype_child(dsdir: str, reads: str, preset: str, name: str,
                   threads: int, extra=(), sampler=None, timeout=600,
                   pool_min_loci=None):
    """`python -m trgt_tpu_torch -vv genotype ... -t N --device cuda` in a
    child process, as a user runs it (`sampler`: a RunSampler told the
    child's pid), killed after `timeout` seconds; with `pool_min_loci`,
    runner.POOL_MIN_LOCI is set to it first. Returns (prefix, wall
    seconds, the workers' debug lines (`worker_lines`), and with N > 1
    the parent's `pool_timeline`)."""
    prefix = os.path.join(dsdir, name)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    entry = ["-m", "trgt_tpu_torch"] if pool_min_loci is None else \
        ["-c", _POOL_CHILD, str(pool_min_loci)]
    cmd = [sys.executable, *entry, "-vv", "genotype",
           "--genome", os.path.join(dsdir, "ref.fasta"),
           "--repeats", os.path.join(dsdir, "repeats.bed"),
           "--reads", os.path.join(dsdir, reads), "--preset", preset,
           "--output-prefix", prefix, "--device", DEVICE, "-t",
           str(threads), *extra]
    epoch, t0 = time.time(), time.perf_counter()
    with subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        if sampler is not None:
            sampler.watch(proc.pid)
        try:
            stderr = proc.communicate(timeout=timeout)[1]
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"genotype -t {threads} exited "
                           f"{proc.returncode}:\n{stderr[-4000:]}")
    return (prefix, wall, worker_lines(stderr, threads),
            pool_timeline(stderr, epoch, wall) if threads > 1 else None)


def worker_lines(stderr: str, threads: int):
    """The `-t N` workers' debug lines of a `-vv` run's stderr: {worker:
    {"ready": s, "done": s, "loci": n, "stages": {...}, "counts": the
    impure filter's reads, "routed": e2e.routed, "cuda_memory": the
    allocator's MiB, "kernels": telemetry snapshot}}, the seconds counted
    from its spawn."""
    workers = {}
    for line in stderr.splitlines():
        m = re.match(r"\[worker (\d+)\] DEBUG worker ready ([\d.]+) s",
                     line)
        if m:
            workers.setdefault(int(m[1]), {})["ready"] = float(m[2])
        m = re.match(r"\[worker (\d+)\] DEBUG worker done ([\d.]+) s after "
                     r"spawn: (\d+) loci, stages (\{.*?\}), counts "
                     r"(\{.*?\}), routed (\{.*?\}), cuda memory (\{.*?\}), "
                     r"kernels (\{.*\})$", line)
        if m:
            workers.setdefault(int(m[1]), {}).update(
                done=float(m[2]), loci=int(m[3]), stages=json.loads(m[4]),
                counts=json.loads(m[5]), routed=json.loads(m[6]),
                cuda_memory=json.loads(m[7]), kernels=json.loads(m[8]))
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
    at -t 4 (smaller ones run on threads), under --preset wgs with `-t
    1/2/4 --device cuda`, each a child process: -t 2 and -t 4 write the
    records of -t 1, every worker that wrote a record launched the Viterbi
    kernel, and the workers together launched every kernel of the path.
    The targeted preset's pool is phase 18's, at 2,500 loci."""
    from trgt_tpu_torch.engine.runner import POOL_MIN_LOCI
    from trgt_tpu_torch.utils.synth import cached_hetero_dataset
    n_loci = POOL_MIN_LOCI * POOL_THREADS[-1]
    preset = "wgs"
    phase(f"worker pool: bench{n_loci}, -t {'/'.join(map(str, POOL_THREADS))}"
          f" --device cuda, {preset}")
    dsdir = cached_hetero_dataset(n_loci, seed=SEED, tag=f"bench{n_loci}",
                                  root=DATA_ROOT)
    runs = {t: genotype_child(dsdir, "reads.bam", preset,
                              f"smoke_pool_{preset}_t{t}", t)
            for t in POOL_THREADS}
    want = records(runs[1][0])
    walls = {t: round(r[1], 3) for t, r in runs.items()}
    print(f"{preset}: walls of the child process (torch import, CUDA "
          f"contexts and worker start-up included) {json.dumps(walls)} s; "
          f"loci/s " + json.dumps(
              {t: round(n_loci / w, 3) for t, w in walls.items()}))
    for t in POOL_THREADS[1:]:
        same = records(runs[t][0]) == want
        workers = runs[t][2]
        print(f"{preset} -t {t}: records == -t 1 {same}; per worker (loci, "
              f"ready s, done s): " + json.dumps(
                  {w: (v["loci"], v.get("ready"), v["done"])
                   for w, v in sorted(workers.items())})
              + f"; the parent (s) {json.dumps(runs[t][3])}")
        if not same:
            raise AssertionError(f"-t {t} records differ from -t 1 "
                                 f"({preset})")
        launched = pool_launches(workers, f"-t {t} {preset}")
        missing = [name for name in PATH_KERNELS[preset] if not launched[name]]
        if missing:
            raise AssertionError(f"-t {t} {preset}: no worker launched "
                                 f"{missing}")


def pool_launches(workers, label):
    """Prints each worker's launches; raises unless every worker that wrote
    a record launched the Viterbi kernel. Returns the launches summed."""
    launched = collections.Counter()
    for w, v in sorted(workers.items()):
        counts = launch_counts(v["kernels"])
        print(f"  worker {w} launches {json.dumps(counts)}")
        if v["loci"] and not counts["viterbi"]:
            raise AssertionError(f"{label}: worker {w} wrote records without "
                                 f"a Viterbi launch")
        launched.update(counts)
    return launched


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


# phase 22: a shard process of the catalog cluster. It reads the group's
# rank and size while the group is up (just before the runner leaves it) and
# prints them, its kernel counters and its peak memory on cuda:0 on its last
# line.
_CLUSTER_CHILD = r"""
import json, sys
import torch
import torch.distributed as dist
from trgt_tpu_torch import mesh
from trgt_tpu_torch.cli import main
from trgt_tpu_torch.kernels import telemetry
group = []
leave = mesh.shutdown_distributed

def shutdown():
    group.append([dist.get_rank(), dist.get_world_size()])
    leave()

mesh.shutdown_distributed = shutdown
telemetry.clear()
rc = main(sys.argv[1:])
print(json.dumps({"rc": rc, "group": group, "kernels": telemetry.snapshot(),
                  "peak_mib_cuda0": torch.cuda.max_memory_allocated(0)
                  / 2**20 if torch.cuda.is_available() else 0.0,
                  "initialized_after": dist.is_initialized()}))
sys.exit(rc)
"""
CLUSTER_RANKS = 2


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(child: str, argv_of, n: int, env: dict, workdir: str,
              timeout: float = 300.0, attempts: int = 3):
    """n processes `python -c child *argv_of(k)` joined through
    TRGT_COORDINATOR_ADDRESS on a free port of this host; [(returncode,
    stdout, stderr)] of each. A rank that fails ends the others. The port is
    free when it is probed, but another process may take it before rank 0
    listens on it: then all ranks run again on another port."""
    for attempt in range(attempts):
        run_env = dict(env, TRGT_COORDINATOR_ADDRESS=f"127.0.0.1:"
                                                     f"{free_port()}")
        logs = [(open(os.path.join(workdir, f"rank{k}.out"), "w+"),
                 open(os.path.join(workdir, f"rank{k}.err"), "w+"))
                for k in range(n)]
        procs = [subprocess.Popen([sys.executable, "-c", child, *argv_of(k)],
                                  cwd=REPO, env=run_env, stdout=out,
                                  stderr=err) for k, (out, err) in
                 enumerate(logs)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(
                        p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for p, files in zip(procs, logs):
            texts = []
            for fh in files:
                fh.seek(0)
                texts.append(fh.read())
                fh.close()
            results.append((p.returncode, *texts))
        if not any("EADDRINUSE" in err for _, _, err in results):
            break
    return results


def cluster_ranks(dsdir: str):
    """CLUSTER_RANKS `genotype --device cuda --preset wgs --shard-count 2
    --shard-index k` child processes joined through TRGT_COORDINATOR_ADDRESS
    (a free port of this host); returns (each rank's last line, its join
    log line)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TRGT_TPU_MESH", None)
    results = run_ranks(_CLUSTER_CHILD, lambda k: [
        "-v", "genotype",
        "--genome", os.path.join(dsdir, "ref.fasta"),
        "--repeats", os.path.join(dsdir, "repeats.bed"),
        "--reads", os.path.join(dsdir, "reads.bam"), "--preset", "wgs",
        "--output-prefix", os.path.join(dsdir, f"smoke_cluster{k}"),
        "--device", DEVICE, "--shard-count", str(CLUSTER_RANKS),
        "--shard-index", str(k)], CLUSTER_RANKS, env, dsdir)
    ranks, joins = [], []
    for k, (rc, out, err) in enumerate(results):
        if rc != 0:
            raise RuntimeError(f"cluster rank {k} exited {rc}:\n"
                               f"{err[-4000:]}")
        ranks.append(json.loads(out.strip().splitlines()[-1]))
        joins.append(next((line.split("] ", 1)[-1]
                           for line in err.splitlines()
                           if "torch.distributed initialized" in line), None))
    return ranks, joins


def phase_cluster(dsdir: str):
    """The catalog cluster and the default mesh: two shard processes of
    bench96 wgs on the card joined through TRGT_COORDINATOR_ADDRESS (each in
    a group of 2, with memory on cuda:0, flank, Viterbi and e2e launched,
    the riffled VCF records and the sorted BAM records == phase 7's cuda and
    host runs); the mesh that a default run in this process installed (none
    on one card), and over several cards a run under the default mesh (==
    phase 7's, every card launched). Returns {kernel: launches by rank}."""
    import torch
    from trgt_tpu_torch import mesh
    from trgt_tpu_torch.kernels import telemetry
    phase(f"cluster: {CLUSTER_RANKS} shard processes of bench{N_LOCI} wgs "
          f"joined through TRGT_COORDINATOR_ADDRESS, the default mesh")
    t0 = time.perf_counter()
    ranks, joins = cluster_ranks(dsdir)
    wall = time.perf_counter() - t0
    by_rank = {name: [launch_counts(r["kernels"])[name] for r in ranks]
               for name in ("flank", "viterbi", "editdist", "e2e")}
    for k, (r, join) in enumerate(zip(ranks, joins)):
        print(f"rank {k}: group (rank, size) {r['group']}, log "
              f"{join!r}, peak on cuda:0 {r['peak_mib_cuda0']:.1f} MiB, "
              f"launches {json.dumps(launch_counts(r['kernels']))}")
    print(f"{CLUSTER_RANKS} ranks in {wall:.3f} s (child start-up and "
          f"rendezvous included)")
    for k, r in enumerate(ranks):
        if r["group"] != [[k, CLUSTER_RANKS]] or r["initialized_after"] \
                or (DEVICE == "cuda" and not r["peak_mib_cuda0"]):
            raise AssertionError(f"rank {k} did not join a group of "
                                 f"{CLUSTER_RANKS} as rank {k} with its "
                                 f"tensors on cuda:0, or did not leave it")
        missing = [name for name in PATH_KERNELS["wgs"]
                   if not launch_counts(r["kernels"])[name]]
        if missing:
            raise AssertionError(f"rank {k} never launched {missing}")
    shards = [records(os.path.join(dsdir, f"smoke_cluster{k}"))
              for k in range(CLUSTER_RANKS)]
    lines = [vcf.splitlines()[1:] for vcf, _ in shards]
    riffled = [lines[i % CLUSTER_RANKS][i // CLUSTER_RANKS]
               for i in range(sum(map(len, lines)))]
    recs = sorted(rec for _, bam in shards for rec in bam_records(bam))
    for device in (DEVICE, "host"):
        vcf, bam = records(os.path.join(dsdir, f"smoke_wgs_{device}"))
        same = riffled == vcf.splitlines()[1:] and \
            recs == sorted(bam_records(bam))
        print(f"riffled VCF records ({len(riffled)}) and sorted BAM records "
              f"({len(recs)}) == phase 7's {device} run: {same}")
        if not same:
            raise AssertionError(f"the cluster's records differ from phase "
                                 f"7's {device} run")

    want = records(os.path.join(dsdir, f"smoke_wgs_{DEVICE}"))
    mesh.disable_mesh()
    mesh.auto_enable(DEVICE)
    installed = mesh.current_mesh()
    n_cards = torch.cuda.device_count()
    print(f"torch.cuda.device_count() {n_cards}; the mesh that a default "
          f"run installs: {installed}")
    if n_cards == 1:
        if installed is not None:
            raise AssertionError("a mesh over one card")
        print("a run under the default mesh over several cards: not run "
              "(one card visible)")
        return by_rank
    telemetry.clear()
    try:
        prefix = run_genotype(dsdir, "reads.bam", DEVICE, "wgs",
                              name="smoke_wgs_default_mesh")
        shards = telemetry.by_shard()
        installed = mesh.current_mesh()
    finally:
        mesh.disable_mesh()
    cards = mesh.visible_devices(DEVICE)
    per_card = [launch_counts(shards.get(k, {})) for k in range(n_cards)]
    same = records(prefix) == want
    print(f"the default mesh {installed}: records == phase 7's {same}; "
          f"launches by card {json.dumps(per_card)}")
    if not same or installed != cards or not all(
            c[k] for c in per_card for k in PATH_KERNELS["wgs"]):
        raise AssertionError("the default mesh run differs from phase 7's, "
                             "or a card launched no kernel of the path")
    return by_rank


# The stress catalogs of phases 15-17, each made from a seed by a synth
# module that is passed in: the port's here, `trgt_tpu.utils.synth` in
# tests/test_torch_stress.py, which makes the pins below with trgt_tpu.
ADVERSARIAL_LOCI = 14
ADVERSARIAL_SEED = 7
# bench-generator loci at read error rates of 5-25 %, TRs capped at 1 kb
NOISY_LOCI = 20
NOISY_SEED = 5
NOISY_ERROR_RATES = (0.05, 0.10, 0.15, 0.20, 0.25)
NOISY_MAX_TR = 1000
# a noisy catalog of another seed, on which trgt_tpu's float32 and float64
# Viterbi paths write different records (ROADMAP C4), and the presets run
# on each noisy catalog
NOISY_C4_SEED = 19
NOISY_PRESETS = {"noisy": ("wgs", "targeted"), "noisy_c4": ("targeted",)}
# the JAX package's own scale point (benchmarks/scale10k.py)
SCALE_LOCI = 10_000
SCALE_THREADS = 4
# the scale loci whose kernel calls are replayed (`scale_replay_ids`)
SCALE_REPLAY_LONGEST = 6
SCALE_REPLAY_DEEPEST = 2
# phase 18: a targeted panel of the same generator, every second read at rq
# 0.85, and its loci whose kernel calls are replayed (`targeted_replay_ids`)
TARGETED_SCALE_LOCI = 2500
TARGETED_SCALE_TAG = "targeted2500"
TARGETED_REPLAY_PAIRS = 4
TARGETED_REPLAY_LONGEST = 2


def make_bench(synth, d: str) -> None:
    """The files of bench96 as `cached_hetero_dataset(N_LOCI, seed=SEED)`
    makes them (without its truth.json)."""
    synth.make_dataset(d, synth.hetero_loci(N_LOCI, seed=SEED), seed=SEED)


def make_adversarial(synth, d: str) -> None:
    """The adversarial catalog of tests/test_adversarial_e2e.py: homopolymer
    and low-complexity motifs, motif-copy stutter and indels near the TR
    boundaries."""
    synth.make_dataset(d, synth.adversarial_loci(ADVERSARIAL_LOCI,
                                                 seed=ADVERSARIAL_SEED),
                       seed=ADVERSARIAL_SEED,
                       read_mutator=synth.adversarial_mutator)


def make_noisy(synth, d: str, n: int = NOISY_LOCI,
               seed: int = NOISY_SEED) -> None:
    """`hetero_loci(n, seed=seed)` with every allele and the reference
    scaled down to at most NOISY_MAX_TR bases and locus i's reads at error
    rate NOISY_ERROR_RATES[i % 5]."""
    loci = scaled_loci(synth, n, seed, NOISY_MAX_TR)
    for i, lc in enumerate(loci):
        lc.error_rate = NOISY_ERROR_RATES[i % len(NOISY_ERROR_RATES)]
    synth.make_dataset(d, loci, seed=seed)


def scaled_loci(synth, n: int, seed: int, max_tr: int):
    """`hetero_loci(n, seed=seed)` with every allele and the reference
    scaled down to at most `max_tr` bases."""
    loci = synth.hetero_loci(n, seed=seed)
    for lc in loci:
        over = max(lc.ref_copies, *lc.allele_copies) * len(lc.motif) / max_tr
        if over > 1:
            lc.ref_copies = max(2, int(lc.ref_copies / over))
            lc.allele_copies = tuple(max(2, int(a / over))
                                     for a in lc.allele_copies)
    return loci


def make_noisy_c4(synth, d: str) -> None:
    make_noisy(synth, d, seed=NOISY_C4_SEED)


# md5s of what trgt_tpu (the JAX package) makes on the CPU, held by
# tests/test_torch_stress.py: the generated catalog and genome, and each
# run's VCF body (the lines that do not start with ##, each with its
# newline: `zcat | grep -v '^##' | md5sum`) and spanning-BAM records (the
# bytes after the BAM header). "cpu" is trgt_tpu --device cpu, its device
# path (float32 Viterbi), "host" its host twins (float64 Viterbi).
FILE_MD5 = {
    "bench96": {"repeats.bed": "8af0584d87b49cc9b9c0d018a9704651",
                "ref.fasta": "0687eb8becb4f478cb419d4a03074546"},
    "adversarial": {"repeats.bed": "04cabb9a6765848b860b6c00b4ef4b70",
                    "ref.fasta": "0f1a1149aaf1faecf661fa01718bef09"},
    "noisy": {"repeats.bed": "803915702feed29a2dd8814cbca0a7f8",
              "ref.fasta": "5d7a9e1559a5e6b9a30f1cf232a61e30"},
    "noisy_c4": {"repeats.bed": "acd3d04636bd37a6ce1c8ee5726528b5",
                 "ref.fasta": "ac0af6bfcdaf47c4ca27b6a7e21025e7"},
    "scale": {"repeats.bed": "a0316fb965d6bb9a5fe0eeef01ab4f93",
              "ref.fasta": "7e46736d7dc22f2798b82596f45791da"},
    "targeted2500": {"repeats.bed": "5268136288d55fa973db2afbbf0306cb",
                     "ref.fasta": "b6f0776a5d6a6cc39bc3511660803c5f"},
    # chip_profile.py scale: the same generator at 10^5 loci
    "scale100k": {"repeats.bed": "184e72cef04aebf438cf37815e0ce4a5",
                  "ref.fasta": "dadf311cdbc3161d9b375cb5c15ddd12"},
}
RUN_MD5 = {
    # phases 7 and 8 (cuda == the port's --device host == these)
    ("bench96", "wgs", "host"): ("080da669659586ada3261a14252b722e",
                                 "ea10e36bc5f001e8d79493dfe9c4dd4a"),
    ("bench96", "targeted", "host"): ("ccfa3163fa1201cb45140d2421ed6af2",
                                      "09456d1aa8b38b31675b0be1756c0dc6"),
    ("adversarial", "size", "host"): ("e5071863807b6d52ba9f3acad9a7e49a",
                                       "59b668a4e62582dd4e5bace738546957"),
    ("adversarial", "cluster", "host"): ("3b8260a197799a6e0ac625049a4ab695",
                                          "efbebe546c47fb7093602c9687c95b19"),
    ("noisy", "wgs", "cpu"): ("5e112733b2bb5e25a45a72f91bf04ecd",
                               "62bfd96bc205a71b776fb5fd1710c5e7"),
    ("noisy", "wgs", "host"): ("5e112733b2bb5e25a45a72f91bf04ecd",
                                "62bfd96bc205a71b776fb5fd1710c5e7"),
    ("noisy", "targeted", "cpu"): ("070d00bd7db5e193f216f4b88a1e9165",
                                    "090af41d00e9fcf628486c5c13fecccb"),
    ("noisy", "targeted", "host"): ("070d00bd7db5e193f216f4b88a1e9165",
                                     "090af41d00e9fcf628486c5c13fecccb"),
    # HET13's sample column differs: the two paths split (NOISY_SPLIT)
    ("noisy_c4", "targeted", "cpu"): ("a237047d1a465c82e3037854f9371037",
                                       "7eb15398561b4d4b0a3dbcc2c2235b81"),
    ("noisy_c4", "targeted", "host"): ("28f2e3d78310b7f84580d31ea28bad24",
                                        "7eb15398561b4d4b0a3dbcc2c2235b81"),
    # trgt_tpu --device host -t 6; CONCORDANCE.md's VCF md5 of this catalog
    ("scale", "wgs", "host"): ("f39a812b71134d8a0fc82b1bbc637490",
                               "6dd972ee50993e34db51f174e71b41c2"),
    # trgt_tpu --device host -t 6 --preset targeted, every second read at
    # rq 0.85 (phase 18)
    ("targeted2500", "targeted", "host"): (
        "d8acbf6b0ee82390bba0966ce2466b40",
        "ac0c4906aa38749ccc2ae873093602e9"),
    # trgt_tpu --device host -t 6 on chip_profile.py scale's 10^5 catalog
    ("scale100k", "wgs", "host"): ("bd76c8b2c91e8b9bfb1172322f922094",
                                   "d3ea299eec3a8392a626dcaeb4ebbbba"),
}
# VCF records in which trgt_tpu --device cpu and --device host differ on
# the noisy catalogs (ROADMAP C4: float32 against float64 Viterbi)
NOISY_SPLIT = {("noisy", "wgs"): 0, ("noisy", "targeted"): 0,
               ("noisy_c4", "targeted"): 1}


def file_md5(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


def records_md5(prefix: str):
    """(VCF body md5, spanning-BAM records md5) of a run, as pinned."""
    vcf, bam = records(prefix)
    return (hashlib.md5((vcf + "\n").encode()).hexdigest(),
            hashlib.md5(bam).hexdigest())


def check_files(name: str, dsdir: str) -> None:
    got = {f: file_md5(os.path.join(dsdir, f)) for f in FILE_MD5[name]}
    print(f"{name} catalog: generated file md5s {json.dumps(got)} == "
          f"trgt_tpu's {got == FILE_MD5[name]}")
    if got != FILE_MD5[name]:
        raise AssertionError(f"the {name} generator made other files than "
                             f"trgt_tpu's (a generator difference, not a "
                             f"genotyping one)")


def stress_dataset(name: str, make) -> str:
    from trgt_tpu_torch.utils import synth
    d = os.path.join(DATA_ROOT, f"stress_{name}")
    os.makedirs(d, exist_ok=True)
    make(synth, d)
    check_files(name, d)
    return d


def n_differing(a: str, b: str) -> int:
    """VCF records (lines) that differ between two bodies."""
    x, y = a.splitlines(), b.splitlines()
    return sum(u != v for u, v in zip(x, y)) + abs(len(x) - len(y))


# the kernels each preset or genotyper must launch
PATH_KERNELS = {"wgs": ("flank", "viterbi", "e2e"),
                "targeted": ("flank", "viterbi", "editdist", "e2e")}


def cuda_and_host(d, reads, preset, name, n_loci, expect, extra=()):
    """A stress catalog under --device cuda (`capture_cuda`), its kernel
    calls replayed against the plain versions, and under --device host;
    raises unless every kernel in `expect` launched. Returns (cuda prefix,
    host prefix, launches, {kernel: numbers of the replay})."""
    cuda, launches, counts, caps = capture_cuda(
        d, reads, preset, name=f"{name}_cuda", n_loci=n_loci, extra=extra)
    missing = [k for k in expect if not launches[k]]
    if missing:
        raise AssertionError(f"{name}: {missing} never launched")
    held = replay(name, kernel_table(), caps, counts)
    del caps
    host = run_genotype(d, reads, "host", preset, name=f"{name}_host",
                        n_loci=n_loci, extra=extra)
    return cuda, host, launches, held


def path_entry(runs):
    """{kernel: {"launches", "max_abs_err", "held_calls", "ms",
    "plain_ms"}} over the (launches, replay numbers) of a phase's cuda
    runs: launches, held calls and times summed, the largest error; the
    Viterbi rows' plain batches (`hold_viterbi_rows`, shared among paths)
    each counted once, and listed."""
    out = {}
    for name in ("flank", "viterbi", "editdist", "e2e"):
        e = {"launches": sum(launches[name] for launches, _ in runs),
             "max_abs_err": 0, "held_calls": 0, "ms": 0.0, "plain_ms": 0.0}
        batches = set()
        for _, held in runs:
            if name in held:
                e["max_abs_err"] = max(e["max_abs_err"],
                                       held[name]["max_abs_err"])
                for key in ("held_calls", "ms", "plain_ms"):
                    e[key] += held[name][key]
                batches.update(held[name].get("plain_batches", ()))
        if batches:
            e["plain_batches"] = sorted(batches)
            e["plain_ms"] = sum(PLAIN_BATCH_MS[b] for b in batches)
        out[name] = e
    return out


def phase_adversarial():
    """The adversarial catalog under --device cuda and host, size and
    cluster genotypers: records equal each other and trgt_tpu's pins, and
    every kernel call of the cuda runs equals its plain version."""
    phase(f"adversarial: {ADVERSARIAL_LOCI} loci, size and cluster "
          f"genotypers, --device cuda vs host vs trgt_tpu's pins")
    d = stress_dataset("adversarial", make_adversarial)
    runs = []
    for genotyper, expect in (("size", PATH_KERNELS["wgs"]),
                              ("cluster", PATH_KERNELS["targeted"])):
        want = RUN_MD5[("adversarial", genotyper, "host")]
        cuda, host, launches, held = cuda_and_host(
            d, "reads.bam", "wgs", f"adv_{genotyper}", ADVERSARIAL_LOCI,
            expect, ["--genotyper", genotyper])
        got = {"cuda": records_md5(cuda), "host": records_md5(host)}
        print(f"adversarial {genotyper}: (VCF, BAM) md5 {json.dumps(got)}; "
              f"== trgt_tpu --device host {json.dumps(list(want))}: "
              f"{got['cuda'] == got['host'] == want}; launches "
              f"{json.dumps(launches)}")
        if not got["cuda"] == got["host"] == want:
            raise AssertionError(f"adversarial {genotyper}: cuda, host and "
                                 f"the pinned trgt_tpu records differ")
        runs.append((launches, held))
    return runs


def phase_noisy():
    """The noisy catalogs under --device cuda: records equal trgt_tpu
    --device cpu's pins (its device path, float32 Viterbi, as the
    port's), the port's --device host (float64) equals trgt_tpu --device
    host's, every kernel call equals its plain version, and cuda differs
    from host in as many records as trgt_tpu's two paths do: none on the
    noisy catalog, NOISY_SPLIT on the C4 catalog, where they split."""
    phase(f"noisy: {NOISY_LOCI} loci at read error rates "
          f"{'/'.join(f'{r:g}' for r in NOISY_ERROR_RATES)}, --device cuda "
          f"vs trgt_tpu --device cpu's pins")
    runs = []
    for catalog, make in (("noisy", make_noisy),
                          ("noisy_c4", make_noisy_c4)):
        d = stress_dataset(catalog, make)
        for preset in NOISY_PRESETS[catalog]:
            reads = "reads.bam" if preset == "wgs" else low_quality_reads(d)
            want = RUN_MD5[(catalog, preset, "cpu")]
            want_host = RUN_MD5[(catalog, preset, "host")]
            cuda, host, launches, held = cuda_and_host(
                d, reads, preset, f"{catalog}_{preset}", NOISY_LOCI,
                PATH_KERNELS[preset])
            got, got_host = records_md5(cuda), records_md5(host)
            split = n_differing(records(cuda)[0], records(host)[0])
            pinned = NOISY_SPLIT[(catalog, preset)]
            print(f"{catalog} {preset}: cuda (VCF, BAM) md5 "
                  f"{json.dumps(got)} == trgt_tpu --device cpu {got == want};"
                  f" the port's --device host == trgt_tpu --device host "
                  f"{got_host == want_host}; records in which cuda differs "
                  f"from the port's --device host: {split} (trgt_tpu --device"
                  f" cpu vs host: {pinned}); launches {json.dumps(launches)}")
            if got != want or got_host != want_host:
                raise AssertionError(f"{catalog} {preset}: cuda records differ"
                                     f" from trgt_tpu --device cpu's, or host"
                                     f" records from trgt_tpu --device host's")
            if split != pinned:
                raise AssertionError(f"{catalog} {preset}: cuda differs from "
                                     f"the float64 host path in {split} "
                                     f"records, trgt_tpu's paths in {pinned}")
            runs.append((launches, held))
    return runs


# makes a catalog of the bench generator in a process of its own
# (benchmarks/scale10k.py does the same), so the generator's memory stays
# out of the readings; with "low_rq" also reads_low_rq.bam
_GENERATOR = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from trgt_tpu_torch.utils.synth import cached_hetero_dataset
t0 = time.perf_counter()
d = cached_hetero_dataset(int(sys.argv[3]), seed=int(sys.argv[4]),
                          tag=sys.argv[5], root=sys.argv[2])
if sys.argv[6] == "low_rq":
    import chip_smoke
    chip_smoke.low_quality_reads(d)
print(d, time.perf_counter() - t0)
"""

# a fresh interpreter's RSS (MiB, /proc) after `import torch`, after the
# CUDA check that the -t N parent makes, and with a CUDA context, as a
# worker holds one: the floor under the pool's readings
_RSS_FLOOR = r"""
import re, torch
def rss():
    with open("/proc/self/status") as fh:
        return int(re.search(r"VmRSS:\s+(\d+) kB", fh.read())[1]) / 1024
imported = rss()
torch.cuda.is_available()
checked = rss()
torch.zeros(1, device="cuda")
print(imported, checked, rss())
"""


def start_generator(n: int, tag: str, low_rq: bool = False,
                    seed: int = SEED, root: str = DATA_ROOT):
    """Starts making `cached_hetero_dataset(n, seed=seed, tag=tag,
    root=root)` (and, with `low_rq`, its `low_quality_reads`) in a child
    process; returns (process, start time)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", _GENERATOR, REPO, root, str(n),
         str(seed), tag, "low_rq" if low_rq else "-"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def wait_generator(generator, label: str, timeout: float = 900) -> str:
    """Waits for a `start_generator` child; returns its dataset's folder."""
    proc, t_gen = generator
    out = proc.communicate(timeout=timeout)[0]
    if proc.returncode != 0:
        raise RuntimeError(f"the {label} generator exited {proc.returncode}")
    dsdir, gen_s = out.split()[-2], float(out.split()[-1])
    print(f"{label} generator (a process of its own): {gen_s:.3f} s, ready "
          f"{time.perf_counter() - t_gen:.3f} s after its start", flush=True)
    return dsdir


def peak_kib(status: str):
    """The peak RSS (KiB) in a /proc/<pid>/status text: VmHWM, or VmRSS
    where the kernel gives no VmHWM (then a sample's RSS, of which the
    sampler keeps the largest)."""
    m = re.search(r"VmHWM:\s+(\d+) kB", status) or \
        re.search(r"VmRSS:\s+(\d+) kB", status)
    return int(m[1]) if m else None


class RunSampler:
    """While active, every `ms` milliseconds: `nvidia-smi` memory.used (MiB)
    and utilization (%), and the RSS of each process under the pid given
    to `watch`, read from /proc: its peak (VmHWM, or the largest VmRSS
    sample where /proc has no VmHWM) and the series of the genotype
    process's and the largest worker's VmRSS; every `apps_every` samples
    the device memory of each compute process (`nvidia-smi
    --query-compute-apps`). Sample times are `time.perf_counter()`."""

    def __init__(self, ms: int = 250, apps_every: int = 8,
                 gpu: bool = True):
        # gpu False: /proc alone, for a run off the card
        self.ms, self.apps_every, self.gpu = ms, apps_every, gpu
        self.peaks = {}
        # (t, genotype process MiB, largest worker MiB), (t, memory.used
        # MiB, utilization %), (t, the largest compute process's MiB)
        self.rss_series, self.smi_series, self.app_series = [], [], []
        # the (pid, MiB) of each compute process in the sample where their
        # sum was largest (a container may show every process as one pid)
        self.app_peak = []
        self.root, self.done = None, threading.Event()

    def watch(self, pid: int) -> None:
        self.root = pid

    def _tree(self):
        children = {}
        for name in os.listdir("/proc"):
            if name.isdigit():
                try:
                    with open(f"/proc/{name}/stat") as fh:
                        ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
                except (OSError, IndexError, ValueError):
                    continue
                children.setdefault(ppid, []).append(int(name))
        out, stack = set(), [self.root]
        while stack:
            pid = stack.pop()
            if pid not in out:
                out.add(pid)
                stack += children.get(pid, [])
        return out

    def _compute_apps(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True).stdout
        used = []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 2 and all(p.isdigit() for p in parts):
                used.append((int(parts[0]), int(parts[1])))
        if sum(m for _, m in used) > sum(m for _, m in self.app_peak):
            self.app_peak = used
        self.app_series.append((time.perf_counter(),
                                max((m for _, m in used), default=0)))

    def _loop(self):
        tick = 0
        while not self.done.wait(self.ms / 1000):
            if self.root is None:
                continue
            t, parent, worker = time.perf_counter(), 0.0, 0.0
            for pid in self._tree():
                try:
                    with open(f"/proc/{pid}/status") as fh:
                        status = fh.read()
                    with open(f"/proc/{pid}/cmdline", "rb") as fh:
                        kind = "worker" if b"engine.worker" in fh.read() \
                            else "genotype process"
                except OSError:
                    continue
                m = peak_kib(status)
                if m:
                    key = (kind, pid)
                    self.peaks[key] = max(self.peaks.get(key, 0), m / 1024)
                now = re.search(r"VmRSS:\s+(\d+) kB", status)
                if now and kind == "worker":
                    worker = max(worker, int(now[1]) / 1024)
                elif now and pid == self.root:
                    parent = int(now[1]) / 1024
            self.rss_series.append((t, parent, worker))
            if self.gpu and tick % self.apps_every == 0:
                self._compute_apps()
            tick += 1

    def _read_smi(self):
        """Reads nvidia-smi's samples as they come (a pipe left unread
        fills and stops it). It stamps each in local time; the offset
        turns its epoch into this process's perf_counter."""
        for line in self.proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 3 or not all(p.isdigit() for p in parts[1:]):
                continue
            stamp, _, frac = parts[0].partition(".")
            try:
                epoch = time.mktime(time.strptime(
                    stamp, "%Y/%m/%d %H:%M:%S")) + float(f"0.{frac}")
            except ValueError:
                continue
            self.smi_series.append((epoch - self.offset, int(parts[1]),
                                    int(parts[2])))

    def __enter__(self):
        self.offset = time.time() - time.perf_counter()
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,memory.used,"
             "utilization.gpu", "--format=csv,noheader,nounits",
             f"-lms={self.ms}"], stdout=subprocess.PIPE, text=True) \
            if self.gpu else None
        loops = [self._loop] + ([self._read_smi] if self.gpu else [])
        self.threads = [threading.Thread(target=fn, daemon=True)
                        for fn in loops]
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.done.set()
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait(timeout=30)
        for t in self.threads:
            t.join(timeout=30)

    def peak_rss(self):
        """{"genotype process": MiB, "largest worker": MiB} from /proc."""
        out = {}
        for (kind, _pid), mib in self.peaks.items():
            key = "largest worker" if kind == "worker" else kind
            out[key] = max(out.get(key, 0.0), mib)
        return out


def truth_check(vcf: str, truth: dict):
    """concordance.py's check: for every error-free locus, the called AL
    (sorted; the first allele alone where haploid) equals the truth.
    Returns (loci checked, failures)."""
    n, failures = 0, []
    for line in vcf.splitlines():
        if line.startswith("#"):
            continue
        fields = line.split("\t")
        info = dict(kv.split("=", 1) for kv in fields[7].split(";")
                    if "=" in kv)
        t = truth.get(info.get("TRID"))
        if t is None or t["error_rate"] > 0.0:
            continue
        n += 1
        sample = dict(zip(fields[8].split(":"), fields[9].split(":")))
        want = t["alleles"][:1] if t["haploid"] else t["alleles"]
        al = sample.get("AL", ".")
        got = "no call" if al == "." else sorted(int(x)
                                                for x in al.split(","))
        if got != want:
            failures.append((info["TRID"], got, want))
    return n, failures


def pool_numbers(label, workers):
    """Prints each `-t N` worker's loci, start-up and end, stage seconds,
    impure-filter reads and allocator MiB, and their sums over the
    workers; raises unless every worker that wrote a record launched the
    Viterbi kernel. Returns {"launches", "stages", "counts", "routed",
    "editdist_pairs", "editdist_cells"} summed over the workers and
    "cuda_memory" by worker."""
    from trgt_tpu_torch.kernels import telemetry
    launched = pool_launches(workers, label)
    stages, counts = collections.Counter(), collections.Counter()
    routed, edit = collections.Counter(), collections.Counter()
    for w, v in sorted(workers.items()):
        print(f"  worker {w}: {v['loci']} loci, ready {v.get('ready')} s, "
              f"done {v['done']} s, stages {json.dumps(v['stages'])}, "
              f"impure filter reads {json.dumps(v['counts'])}, cuda memory "
              f"(MiB) {json.dumps(v['cuda_memory'])}")
        stages.update(v["stages"])
        counts.update(v["counts"])
        routed.update(v["routed"])
        edit.update(telemetry.totals(v["kernels"]).get("editdist", {}))
    out = {"launches": dict(launched),
           "stages": {k: round(v, 3) for k, v in stages.items()},
           "counts": dict(counts),
           "routed": {k: round(v, 3) for k, v in routed.items()},
           "editdist_pairs": edit["bytes_out"] // 4,
           "editdist_cells": edit["cells"],
           "cuda_memory": {w: v["cuda_memory"]
                           for w, v in sorted(workers.items())}}
    print(f"{label}, summed over the workers: stage seconds "
          f"{json.dumps(out['stages'])}; launches {json.dumps(out['launches'])}"
          f"; e2e.routed {json.dumps(out['routed'])}; impure filter reads "
          f"{json.dumps(out['counts'])}; editdist pairs "
          f"{out['editdist_pairs']}, cells {out['editdist_cells']}")
    return out


def scale_run(label, dsdir, reads, preset, name, n_loci, pin, timeout=600):
    """`genotype_child` at -t SCALE_THREADS under a RunSampler: prints the
    wall and loci/s, the peak RSS, `memory.used`, the device memory of each
    compute process, the busy share and the workers' numbers
    (`pool_numbers`); holds the records against RUN_MD5[pin] (pin None:
    printed only), n_loci VCF records and the truth AL of every error-free
    locus. Returns (prefix, sampler, workers' numbers, (start, end) on the
    perf_counter clock, wall)."""
    with RunSampler() as gpu:
        time.sleep(1)
        t0 = time.perf_counter()
        prefix, wall, workers, timeline = genotype_child(
            dsdir, reads, preset, name, SCALE_THREADS, sampler=gpu,
            timeout=timeout)
        t1 = time.perf_counter()
    print(f"{label}: {n_loci} loci in {wall:.3f} s = {n_loci / wall:.3f} "
          f"loci/s (the child process, start-up included); the parent (s) "
          f"{json.dumps(timeline)}")
    mem = [m for _, m, _ in gpu.smi_series]
    busy = [b for _, _, b in gpu.smi_series]
    print(f"{label}: peak RSS (MiB, /proc samples every {gpu.ms} ms) "
          f"{json.dumps(gpu.peak_rss())}; nvidia-smi memory.used max "
          f"{max(mem)} MiB (before the run {mem[0]} MiB), utilization.gpu "
          f"mean {sum(busy) / len(busy):.2f} % over {len(busy)} samples; "
          f"(pid, MiB) of each compute process at their largest sum "
          f"(--query-compute-apps) {json.dumps(gpu.app_peak)}")
    numbers = pool_numbers(label, workers)
    got = records_md5(prefix)
    vcf = records(prefix)[0]
    n_rec = sum(1 for line in vcf.splitlines() if not line.startswith("#"))
    with open(os.path.join(dsdir, "truth.json")) as fh:
        n_truth, failures = truth_check(vcf, json.load(fh))
    want = RUN_MD5.get(pin) if pin else None
    print(f"{label}: {n_rec} VCF records; (VCF, BAM) md5 {json.dumps(got)} "
          + (f"== trgt_tpu --device host -t 6 {got == want}" if want else
             "(no pin for this catalog)")
          + f"; truth AL of error-free loci {n_truth - len(failures)}/"
          f"{n_truth}")
    if (want and got != want) or n_rec != n_loci or failures or not n_truth:
        raise AssertionError(f"{label}: records differ from trgt_tpu's, or "
                             f"{n_rec} records, or truth failures "
                             f"{failures[:5]}")
    return prefix, gpu, numbers, (t0, t1), wall


def phase_scale(generator):
    """`genotype -t SCALE_THREADS --device cuda` (the worker pool) of the
    10^4-locus catalog as a child process: records == trgt_tpu --device
    host's pins, SCALE_LOCI VCF records, truth AL of every error-free
    locus; its wall, peak RSS, device memory and the workers' stages and
    launches; then `scale_replay_ids` alone (`replay_loci`). Returns (the
    workers' launches, [(replayed loci's launches, replay numbers)])."""
    phase(f"scale: {SCALE_LOCI} loci (cached_hetero_dataset(tag='scale'), "
          f"seed {SEED}), genotype -t {SCALE_THREADS} --device cuda")
    dsdir = wait_generator(generator, "scale")
    check_files("scale", dsdir)
    import torch
    torch.cuda.empty_cache()
    prefix, _, numbers, _, _ = scale_run(
        "scale", dsdir, "reads.bam", "wgs", "smoke_scale", SCALE_LOCI,
        ("scale", "wgs", "host"))
    floor = [float(x) for x in subprocess.run(
        [sys.executable, "-c", _RSS_FLOOR], check=True, capture_output=True,
        text=True).stdout.split()]
    print(f"scale: a fresh interpreter's RSS (MiB) after import torch "
          f"{floor[0]:.1f}, after the CUDA check {floor[1]:.1f}, with a CUDA "
          f"context {floor[2]:.1f}")
    missing = [k for k in PATH_KERNELS["wgs"] if not numbers["launches"][k]]
    if missing:
        raise AssertionError(f"scale: {missing} never launched")
    launches, held, _ = replay_loci("scale loci", dsdir, prefix,
                                    scale_replay_ids(), "reads.bam", "wgs")
    shapes, bench = PATH_SHAPES["scale loci"], [
        PATH_SHAPES[p] for p in ("wgs", "targeted")]
    beyond = {k: v > max(b[k] for b in bench) for k, v in shapes.items()
              if not k.startswith("band_max")}
    print(f"scale loci: shapes beyond bench{N_LOCI}'s paths "
          f"{json.dumps(beyond)}")
    return numbers["launches"], [(launches, held)]


def replay_ids(n_loci, n_longest, n_other, other):
    """Ids of the `n_longest` loci of `hetero_loci(n_loci, seed=SEED)` with
    the longest alleles (the longest Viterbi queries, flank texts over a
    tile, the widest bands) and of the first `n_other` of the rest in the
    order of the sort key `other`."""
    from trgt_tpu_torch.utils.synth import hetero_loci
    loci = hetero_loci(n_loci, seed=SEED)
    longest = sorted(loci, key=lambda lc: -max(lc.allele_copies)
                     * len(lc.motif))[:n_longest]
    picked = {lc.id for lc in longest}
    rest = sorted((lc for lc in loci if lc.id not in picked), key=other)
    return picked | {lc.id for lc in rest[:n_other]}


def scale_replay_ids():
    """The scale loci whose kernel calls are replayed: the longest alleles
    and the deepest error-free loci (the most reads a call)."""
    return replay_ids(SCALE_LOCI, SCALE_REPLAY_LONGEST, SCALE_REPLAY_DEEPEST,
                      lambda lc: (bool(lc.error_rate), -lc.depth))


def cluster_pairs(lc) -> float:
    """The edit-distance pairs that the cluster genotyper is expected to
    send for a locus of the bench generator: a read whose TR carries a
    substitution is a sequence of its own (half the depth on each allele,
    substitutions at the locus's error rate), and every pair of them goes
    to the kernel where both alleles are at most 100 bases (len_a * len_b
    <= MAX_OPS); 0 where the longer allele is longer."""
    from trgt_tpu_torch.kernels.editdist import MAX_OPS
    lens = [c * len(lc.motif) for c in lc.allele_copies]
    if max(lens) ** 2 > MAX_OPS:
        return 0.0
    distinct = sum(lc.depth / 2 * (1 - (1 - (lc.error_rate or 0.0)) ** n)
                   for n in lens)
    return distinct * (distinct - 1) / 2


def targeted_replay_ids():
    """The targeted-scale loci whose kernel calls are replayed: the
    longest alleles (the impure filter's longest Viterbi queries too) and
    the loci with the most cluster pairs (`cluster_pairs`: the
    edit-distance kernel's largest calls)."""
    return replay_ids(TARGETED_SCALE_LOCI, TARGETED_REPLAY_LONGEST,
                      TARGETED_REPLAY_PAIRS, lambda lc: -cluster_pairs(lc))


def replay_loci(label, dsdir, prefix, ids, reads, preset):
    """The loci `ids` alone, genotyped in this process with --device cuda
    (`capture_cuda`): their records equal those of the `-t N` run at
    `prefix`, and every kernel call equals its plain version (`replay`).
    Returns (launches, replay numbers, the run's counters)."""
    with open(os.path.join(dsdir, "repeats.bed")) as fh:
        lines = [line for line in fh
                 if re.search(r"ID=([^;]+)", line)[1] in ids]
    bed = f"repeats_{label.replace(' ', '_')}.bed"
    with open(os.path.join(dsdir, bed), "w") as fh:
        fh.writelines(lines)
    sub, launches, counts, caps = capture_cuda(
        dsdir, reads, preset, name=f"smoke_{label.replace(' ', '_')}",
        n_loci=len(lines), repeats=bed)
    launches.pop("e2e_band")
    vcf, bam = records(sub)
    full_vcf, full_bam = records(prefix)
    want = [line for line in full_vcf.splitlines()[1:]
            if re.search(r"TRID=([^;]+)", line)[1] in ids]
    sub_bam = collections.Counter(bam_records(bam))
    same_vcf = vcf.splitlines()[1:] == want
    same_bam = not sub_bam - collections.Counter(bam_records(full_bam))
    print(f"{label} {sorted(ids)} alone: {len(lines)} VCF records == the "
          f"-t {SCALE_THREADS} run's {same_vcf}; their "
          f"{sum(sub_bam.values())} spanning-BAM records among its "
          f"{same_bam}; launches {json.dumps(launches)}")
    if len(lines) != len(ids) or not same_vcf or not same_bam:
        raise AssertionError(f"{label} alone differ from the -t "
                             f"{SCALE_THREADS} run")
    held = replay(label, kernel_table(), caps, counts)
    return launches, held, counts


def phase_targeted_scale(generator):
    """`genotype --preset targeted -t SCALE_THREADS --device cuda` of the
    2,500-locus catalog, every second read at rq 0.85, as a child process:
    records == trgt_tpu --device host -t 6's pins, 2,500 VCF records,
    truth AL of every error-free locus, every worker that wrote a record
    launched Viterbi and the workers together all four kernels; then
    `targeted_replay_ids` alone (`replay_loci`). Returns (the workers'
    numbers, [(replayed loci's launches, replay numbers)])."""
    phase(f"targeted at scale: {TARGETED_SCALE_LOCI} loci "
          f"(cached_hetero_dataset(tag={TARGETED_SCALE_TAG!r}), seed {SEED}),"
          f" every second read rq 0.85, genotype --preset targeted -t "
          f"{SCALE_THREADS} --device {DEVICE}")
    dsdir = wait_generator(generator, TARGETED_SCALE_TAG)
    check_files(TARGETED_SCALE_TAG, dsdir)
    import torch
    torch.cuda.empty_cache()
    prefix, _, numbers, _, _ = scale_run(
        "targeted at scale", dsdir, LOW_RQ_READS, "targeted",
        "smoke_targeted_scale", TARGETED_SCALE_LOCI,
        (TARGETED_SCALE_TAG, "targeted", "host"))
    missing = [k for k in PATH_KERNELS["targeted"]
               if not numbers["launches"][k]]
    if missing:
        raise AssertionError(f"targeted at scale: no worker launched "
                             f"{missing}")
    launches, held, counts = replay_loci(
        "targeted loci", dsdir, prefix, targeted_replay_ids(), LOW_RQ_READS,
        "targeted")
    edit = counts.get("editdist", {})
    print(f"targeted loci alone: editdist pairs {edit.get('bytes_out', 0) // 4}"
          f", cells {edit.get('cells', 0)}")
    return numbers, [(launches, held)]


# phase 19: the bench generator's catalog with its TRs scaled to at most
# FLAGS_MAX_TR bases (so that the replays' plain versions stay short; the
# long alleles are phases 7-8's and 17's), under the non-default flags of
# tests/test_torch_flags.py
FLAGS_LOCI = N_LOCI
FLAGS_MAX_TR = 1000
MIXED_RQ_READS = "reads_mixed_rq.bam"
# read quality by read index: under 0.5 (dropped at --min-read-quality
# 0.5), under 0.9 (labelled by the impure-read filter) and HiFi
MIXED_RQ = (0.3, 0.85, 0.999)
# name: (preset, reads, flags). Depths of the generator run to 200: over
# 3 x 2 the read extraction's reservoir walk runs, over 20 the downsample
# of the spanning reads (BatchPipeline._finish_spans)
FLAG_SETS = {
    "max_depth_2": ("wgs", "reads.bam", ("--max-depth", "2")),
    "max_depth_20": ("wgs", "reads.bam", ("--max-depth", "20")),
    "aln_scoring_wgs": ("wgs", "reads.bam", ("--aln-scoring", "1,1,1")),
    "aln_scoring_targeted": ("targeted", LOW_RQ_READS,
                             ("--aln-scoring", "3,6,2")),
    "min_flank_id_frac": ("wgs", "reads.bam",
                          ("--min-flank-id-frac", "0.9")),
    "min_read_quality": ("wgs", MIXED_RQ_READS,
                         ("--min-read-quality", "0.5")),
    "output_flank_len": ("wgs", "reads.bam", ("--output-flank-len", "10")),
}
# warnings of the read extraction that show which path a locus took
FLAG_WARNINGS = ("Reservoir sampling reads", "Quality filtered")
FLAGS_POOL_THREADS = 2


class WarningCount:
    """Counts, while active, the warnings of the "trgt" logger that hold
    each of FLAG_WARNINGS, and the spanning-read lists that
    `_finish_spans` downsampled."""

    def __enter__(self):
        import logging
        from trgt_tpu_torch.engine import pipeline
        self.counts = collections.Counter()
        counts = self.counts

        class Handler(logging.Handler):
            def emit(self, record):
                for key in FLAG_WARNINGS:
                    if key in record.getMessage():
                        counts[key] += 1

        self.handler = Handler(logging.WARNING)
        logging.getLogger("trgt").addHandler(self.handler)
        self.downsample = Capture(pipeline, "uniform_downsample").__enter__()
        return self

    def __exit__(self, *exc):
        import logging
        logging.getLogger("trgt").removeHandler(self.handler)
        self.downsample.__exit__(*exc)
        self.counts["downsampled"] = len(self.downsample.calls)
        self.downsample.calls.clear()


def phase_flags():
    """The non-default flags on the card: each flag set of FLAG_SETS under
    --device cuda (`capture_cuda`, every kernel call replayed against its
    plain version) and --device host, identical records; then the catalog
    as a CRAM written by the port's CramWriter through the -t 2 worker pool
    under --device cuda: the VCF records of the BAM run under cuda, and
    the records of the CRAM under --device host. Returns ([(launches,
    replay numbers)] of the flag sets, the pool workers' launches)."""
    from trgt_tpu_torch.utils import synth
    phase(f"flags: {FLAGS_LOCI} loci of the bench generator (TRs up to "
          f"{FLAGS_MAX_TR} bases), {len(FLAG_SETS)} non-default flag sets "
          f"and CRAM through -t {FLAGS_POOL_THREADS}, --device cuda vs host")
    d = os.path.join(DATA_ROOT, f"flags{FLAGS_LOCI}")
    os.makedirs(d, exist_ok=True)
    synth.make_dataset(d, scaled_loci(synth, FLAGS_LOCI, SEED, FLAGS_MAX_TR),
                       seed=SEED)
    low_quality_reads(d)
    rq_reads(d, MIXED_RQ_READS, MIXED_RQ)
    runs = []
    for name, (preset, reads, flags) in FLAG_SETS.items():
        with WarningCount() as seen:
            cuda, host, launches, held = cuda_and_host(
                d, reads, preset, f"flags_{name}", FLAGS_LOCI, ("viterbi",),
                flags)
        same = records(cuda) == records(host)
        print(f"flags {name} ({' '.join(flags)}, --preset {preset}, "
              f"{reads}): cuda records == host {same}; launches "
              f"{json.dumps(launches)}; in both runs {json.dumps(seen.counts)}")
        if not same:
            raise AssertionError(f"flags {name}: cuda and host records "
                                 f"differ")
        runs.append((launches, held))
        if name == "max_depth_2" and not seen.counts[FLAG_WARNINGS[0]]:
            raise AssertionError("--max-depth 2: no reservoir walk")
        if name == "max_depth_20" and not seen.counts["downsampled"]:
            raise AssertionError("--max-depth 20: no downsample")
        if name == "min_read_quality" and not seen.counts[FLAG_WARNINGS[1]]:
            raise AssertionError("--min-read-quality 0.5: no read dropped")

    ids = [re.search(r"ID=([^;]+)", line)[1]
           for line in open(os.path.join(d, "repeats.bed"))]
    bed, bam, cram = write_cram_subset(d, ids)[:3]
    bam_cuda = run_genotype(d, bam, DEVICE, "wgs", bed, "flags_bam_cuda",
                            FLAGS_LOCI)
    cram_host = run_genotype(d, cram, "host", "wgs", bed, "flags_cram_host",
                             FLAGS_LOCI)
    # the CRAM holds every locus's reads, so the whole catalog runs
    pool, wall, workers, _ = genotype_child(
        d, cram, "wgs", "flags_cram_pool", FLAGS_POOL_THREADS,
        pool_min_loci=0)
    launched = pool_launches(workers, "flags CRAM pool")
    got = records(pool)
    same_bam_run = got[0] == records(bam_cuda)[0]
    same_host = got == records(cram_host)
    print(f"flags CRAM -t {FLAGS_POOL_THREADS} --device cuda (the worker "
          f"pool, {wall:.3f} s): VCF records == the BAM cuda run's "
          f"{same_bam_run}; records == the CRAM host run's {same_host}; "
          f"launches {json.dumps(dict(launched))}")
    missing = [k for k in PATH_KERNELS["wgs"] if not launched[k]]
    if not same_bam_run or not same_host or missing:
        raise AssertionError(f"CRAM through the pool differs from the BAM "
                             f"run or from its host run, or {missing} never "
                             f"launched")
    return runs, dict(launched)


def phase_bench():
    """`bench_torch.py --cell bench96-wgs --repeats 1` as a child process,
    as a user runs it: its result line (the last) is correct and the wgs
    path's kernels launched. Returns that line."""
    phase("bench: bench_torch.py --cell bench96-wgs --repeats 1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--cell",
         "bench96-wgs", "--repeats", "1"], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"bench_torch.py exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = {k: result["kernels"].get(k, {}).get("launches", 0)
                for k in PATH_KERNELS["wgs"]}
    print(f"bench96-wgs: correct {result['correct']} by "
          f"{result['correct_by']}, loci/s {json.dumps(result['loci_per_s'])},"
          f" setup {result['setup_s']:.3f} s, host anchor "
          f"{result['host_loci_per_s']:.3f} loci/s, busy share "
          f"{result['busy_share']}, profiled busy share "
          f"{(result['profile'] or {}).get('busy_share')}, launches "
          f"{json.dumps(launches)}, card {json.dumps(result['card'])}")
    if result.get("kind") != "result" or not result["correct"] or \
            result["partial"] or result["platform"] != "gpu" or \
            not all(launches.values()):
        raise AssertionError("bench_torch.py: the result is not correct, "
                             "partial, off the card, or a kernel of the wgs "
                             "path never launched")
    return result


# the Viterbi calls of every replayed path, their rows held against the
# plain version after the last phase (`hold_viterbi_rows`): {"path", "calls":
# [(kernel output on the host, hmms, queries)], "entry": the path's replay
# numbers, filled in then}
PENDING_ROWS = []
# bytes one batch of the plain Viterbi may take for its traceback words
# (reckoned as 18 bytes a row, position and state: the int64 predecessors
# and validity flags, listed and then stacked)
PLAIN_VITERBI_BYTES = 16 << 30
# {plain batch: ms} of `hold_viterbi_rows`
PLAIN_BATCH_MS = {}


def plain_row_batches(calls):
    """`calls` (kernel output, hmms, queries) in the order of their padded
    query length, cut into batches of at most PLAIN_VITERBI_BYTES."""
    batches, cur = [], []
    for call in sorted(calls, key=lambda c: c[0].shape[0]):
        rows = sum(len(c[2]) for c in cur) + len(call[2])
        length = call[0].shape[0]
        states = max(h.num_states for c in cur + [call] for h in c[1])
        if cur and 18 * rows * length * states > PLAIN_VITERBI_BYTES:
            batches.append(cur)
            cur = []
        cur.append(call)
    if cur:
        batches.append(cur)
    return batches


def hold_viterbi_rows():
    """Every replayed path's Viterbi calls against the plain version: the
    rows of all calls up to REPLAY_MAX_L positions in one batch, those of
    all longer calls in another (each cut at PLAIN_VITERBI_BYTES), held
    call by call (`hold_rows`). Fills each path's max_abs_err, plain_ms
    (the batches that held its rows) and held_in_plain_batches."""
    from trgt_tpu_torch.kernels import viterbi as vt
    recs = list(PENDING_ROWS)
    PENDING_ROWS.clear()
    calls = [(got, hmms, queries, rec) for rec in recs
             for got, hmms, queries in rec["calls"]]
    short = [c for c in calls if c[0].shape[0] - 1 <= REPLAY_MAX_L]
    rest = [c for c in calls if c[0].shape[0] - 1 > REPLAY_MAX_L]
    batches = plain_row_batches(short) + plain_row_batches(rest)
    phase(f"replay: the Viterbi rows of {len(recs)} paths ({len(calls)} "
          f"calls) against {len(batches)} plain batches")
    for rec in recs:
        rec.update(err=0, plain_ms=0.0, batches=[])
    for i, batch in enumerate(batches):
        errs, ms = hold_rows(vt.viterbi_plain, [c[0] for c in batch],
                             [(c[1], c[2]) for c in batch])
        PLAIN_BATCH_MS[i] = ms
        paths = []
        for (_, _, _, rec), err in zip(batch, errs):
            rec["err"] = max(rec["err"], err)
            if i not in rec["batches"]:
                rec["batches"].append(i)
                rec["plain_ms"] += ms
                paths.append(rec["path"])
        print(f"plain batch {i}: {sum(len(c[2]) for c in batch)} rows of "
              f"{len(batch)} calls, {batch[-1][0].shape[0] - 1} positions, "
              f"paths {paths}: {ms:.3f} ms, max_abs_err {max(errs)}",
              flush=True)
    for rec in recs:
        n_short = sum(1 for c in short if c[3] is rec)
        rec["entry"].update(
            max_abs_err=rec["err"], plain_ms=rec["plain_ms"],
            plain_batches=rec["batches"],
            held_in_plain_batches=[n_short, len(rec["calls"]) - n_short])
        print(f"viterbi: the {len(rec['calls'])} {rec['path']}-path calls "
              f"held row by row in plain batches {rec['batches']} "
              f"({rec['plain_ms']:.3f} ms): max_abs_err {rec['err']} "
              f"(tolerance 0)")
    bad = [rec["path"] for rec in recs if rec["err"] != 0]
    if bad:
        raise AssertionError(f"viterbi kernel disagrees with its plain "
                             f"version on the paths {bad}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    generators = []
    try:
        return run_phases(t_start, generators)
    finally:
        for proc, _ in generators:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(t_start, generators) -> int:
    import torch
    seconds = {}

    def run(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = round(time.perf_counter() - t0, 1)
        print(f"   ({seconds[label]:.1f} s)", flush=True)
        return out

    phase_env()
    for label, fn in (("2 build", phase_build), ("3 flank", phase_flank),
                      ("4 viterbi", phase_viterbi),
                      ("5 editdist", phase_editdist),
                      ("6 e2e", phase_e2e_fuzz)):
        run(label, fn)
    paths, dsdir = run("7-8 paths", phase_paths)
    cram_launches = run("9 cram", phase_cram, dsdir)
    run("10 commands", phase_commands, dsdir)
    run("11 merge at scale", phase_merge_scale, dsdir)
    # the 10^4 and 2,500-locus catalogs are made beside phases 12-16 (their
    # host-clock numbers share the CPU with them), none of the phases before
    generators.append(start_generator(SCALE_LOCI, "scale"))
    generators.append(start_generator(TARGETED_SCALE_LOCI, TARGETED_SCALE_TAG,
                                      low_rq=True))
    run("12 worker pool", phase_pool)
    mesh_launches = run("13 mesh", phase_mesh, dsdir)
    run("14 karyotype and shards", phase_ploidy_shards, dsdir)
    cluster = run("22 cluster", phase_cluster, dsdir)
    adversarial = run("15 adversarial", phase_adversarial)
    noisy = run("16 noisy", phase_noisy)
    scale_launched, scale_runs = run("17 scale", phase_scale, generators[0])
    targeted_scale, targeted_runs = run(
        "18 targeted at scale", phase_targeted_scale, generators[1])
    flags, flags_pool = run("19 flags", phase_flags)
    run("20 bench", phase_bench)
    run("21 viterbi rows", hold_viterbi_rows)

    loci_paths = {"scale_path": (scale_launched, path_entry(scale_runs)),
                  "targeted_scale_path": (targeted_scale["launches"],
                                          path_entry(targeted_runs))}
    kernels = []
    for name, k in kernel_table().items():
        launches, held = paths["targeted"]
        entry = {"name": name, "route": "cuda", "source": k["source"],
                 "replaces": k["replaces"], "launches": launches[name],
                 **held[name]}
        if "also_replaces" in k:
            entry["also_replaces"] = k["also_replaces"]
        if name == "e2e":
            entry["band_launches"] = launches["e2e_band"]
        wgs_launches, wgs = paths["wgs"]
        if name in wgs:
            entry["wgs_path"] = {"launches": wgs_launches[name], **wgs[name]}
            if name == "e2e":
                entry["wgs_path"]["band_launches"] = wgs_launches["e2e_band"]
        entry["cram_path"] = {"launches": cram_launches[name]}
        entry["pool_path"] = {"launches": targeted_scale["launches"][name]}
        entry["mesh_path"] = {"launches_by_shard": mesh_launches[name]}
        entry["cluster_path"] = {"launches_by_rank": cluster[name]}
        entry["adversarial_path"] = path_entry(adversarial)[name]
        entry["noisy_path"] = path_entry(noisy)[name]
        entry["flags_path"] = path_entry(flags)[name]
        entry["flags_pool_path"] = {"launches": flags_pool[name]}
        for key, (launched, numbers) in loci_paths.items():
            entry[key] = dict(numbers[name])
            entry[key]["replayed_loci_launches"] = entry[key]["launches"]
            entry[key]["launches"] = launched[name]
        if name == "editdist":
            entry["targeted_scale_path"]["pairs"] = \
                targeted_scale["editdist_pairs"]
            entry["targeted_scale_path"]["cells"] = \
                targeted_scale["editdist_cells"]
        kernels.append(entry)
    print(f"phase seconds {json.dumps(seconds)}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(gpu_name_power())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
