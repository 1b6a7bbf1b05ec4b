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
                  0..100 bases a side and some 1 x 10000
  6. e2e          kernel == plain version, exactly (score, direction
                  bits, CIGAR runs), on pairs of 1..1000 bases under the
                  scorings (2,5,1) and (1,0,1); CIGARs equal to the host
                  aligner's
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
Both replays time the kernel and reckon its bound over every call of the
path, and hold every call against the plain version. The plain Viterbi
takes dense tables built from the HMMs' edge lists, not from the kernel's
sparse ones. It walks positions in Python, at a cost that hardly depends
on the number of rows: calls up to a padded query length of REPLAY_MAX_L
it runs one by one; the rows of all longer calls it runs as one batch,
against which each call's kernel output is held row by row. The
second-to-last line is
{"kernels": [...]}: one entry per kernel with the targeted path's numbers
and, under "wgs_path", the same numbers of the wgs path. The last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of trgt_tpu.
"""

import contextlib
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
# a path's Viterbi calls up to this padded query length are run through
# the plain version one by one; the longer ones share one plain batch (the
# plain version walks positions in Python, a quarter to half a second per
# 100 positions whatever the batch holds)
REPLAY_MAX_L = 2048
# the Viterbi kernel is also timed over the calls up to this padded query
# length alone ("ms_prev_calls"): the calls that the time of the kernel
# before its redesign covered (PERF.md's kernel table keeps that time)
PREV_MAX_L = 4096

# roofline of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and the
# non-tensor-core fp32 rate, which also stands in for the int32 rate of
# the three integer kernels
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


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


def tensor_bytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(tensor_bytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(v) for v in x)
    return 0


# operations per DP cell counted for the bound: the recurrence's own
# adds, compares and selects, no index arithmetic
FLANK_OPS_PER_CELL = 30      # D, diag, N, scan, I, H and four payloads
EDIT_OPS_PER_CELL = 5        # compare, add, two mins, add
E2E_OPS_PER_CELL = 14        # D, diag, N, scan, I, H and the bit packing


def work_flank(args):
    pattern, text, lens = args[:3]
    rows = (pattern != 0).sum(dim=1).double()
    cells = float((rows * (lens.double() + 1)).sum())
    return cells * FLANK_OPS_PER_CELL


def work_viterbi(args):
    # one add and one compare per real edge of the row's HMM and position:
    # an edge into an emitting state is relaxed once across positions, an
    # edge into a silent state once in its level
    _tokens, tables, lens, _ends, _num_levels = args
    edges = tables["e_off"][:, -1].double()                        # (U,)
    return float((lens.double() * edges[tables["u_map"].long()]).sum()) * 2.0


def work_editdist(args):
    a, b, len_a, len_b = args
    return float((len_a.double() * len_b.double()).sum()) * EDIT_OPS_PER_CELL


def work_e2e(args):
    len_p, len_t = args[2], args[3]
    cells = float(((len_p.double() + 1) * (len_t.double() + 1)).sum())
    return cells * E2E_OPS_PER_CELL


def bytes_e2e(args, out) -> int:
    # what the function must move: both sequences at their true lengths
    # and the two lengths in; the score, the run count and the CIGAR runs
    # out. The direction bits are the kernel's working state between scan
    # and traceback and the padding is the wrapper's, so neither counts.
    len_p, len_t = args[2], args[3]
    n_runs = out[3]
    return int(len_p.sum() + len_t.sum()) + 8 * len_p.numel() + \
        8 * n_runs.numel() + 4 * int(n_runs.sum())


def bound_ms(kernel, work, calls, io_bytes=None):
    """The least time the card could take for these calls: the larger of
    bytes (every input read once, every output written once: the tensors
    as the function takes and returns them, or `io_bytes(args, out)`) over
    the HBM rate and operations over the fp32/int32 rate."""
    n_bytes, n_ops = 0, 0.0
    for args in calls:
        out = kernel(*args)
        n_bytes += (io_bytes(args, out) if io_bytes
                    else tensor_bytes(args) + tensor_bytes(out))
        n_ops += work(args)
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, n_ops)


def kernel_table():
    from trgt_tpu_torch.kernels import e2e, editdist
    from trgt_tpu_torch.kernels import semiglobal as sg
    from trgt_tpu_torch.kernels import viterbi as vt
    return {
        "flank": dict(module=sg, fn="flank_align", plain=sg.flank_align_plain,
                      work=work_flank,
                      source="trgt_tpu_torch/csrc/flank.cu",
                      replaces="trgt_tpu/kernels/semiglobal_pallas.py:79",
                      also_replaces="trgt_tpu/kernels/"
                                    "semiglobal_pallas.py:220"),
        "viterbi": dict(module=vt, fn="viterbi_segs", plain=vt.viterbi_plain,
                        work=work_viterbi,
                        source="trgt_tpu_torch/csrc/viterbi.cu",
                        replaces="trgt_tpu/kernels/viterbi.py:217"),
        "editdist": dict(module=editdist, fn="edit_distances",
                         plain=editdist.edit_distances_plain,
                         work=work_editdist,
                         source="trgt_tpu_torch/csrc/editdist.cu",
                         replaces="trgt_tpu/kernels/editdist_pallas.py:41"),
        "e2e": dict(module=e2e, fn="e2e_scan", plain=e2e.e2e_scan_plain,
                    work=work_e2e, io_bytes=bytes_e2e,
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
    import importlib.util
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
    got = ed.edit_distances_batch(pairs[:600], dev)
    want = [edit_distance(a, b) for a, b in pairs[:600]]
    if got != want:
        raise AssertionError("edit_distances_batch disagrees with the host "
                             "twin align_host.edit_distance")
    print("editdist: edit_distances_batch == align_host.edit_distance on "
          "600 of the pairs")


def phase_e2e_fuzz(n_pairs: int = 240, seed: int = 17):
    import torch
    from trgt_tpu_torch.kernels import e2e
    from trgt_tpu_torch.kernels.align_host import align_end_to_end
    from trgt_tpu_torch.kernels.bucket import bucket
    phase(f"e2e: kernel vs plain and host aligner, {n_pairs} fuzzed pairs, "
          f"two scorings")
    rng = random.Random(seed)
    dev = torch.device(DEVICE)
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
    by_key = {}
    for p, t in pairs:
        by_key.setdefault((bucket(len(p)), bucket(len(t))),
                          []).append((p, t))
    for mism, gapo, gape in ((2, 5, 1), (1, 0, 1)):
        calls = [[torch.from_numpy(x).to(dev)
                  for x in e2e.encode_problems(items)] + [mism, gapo, gape]
                 for _key, items in sorted(by_key.items())]
        err, ms, plain_ms = compare(e2e.e2e_scan, e2e.e2e_scan_plain, calls)
        print(f"e2e fuzz ({mism},{gapo},{gape}): {n_pairs} pairs in "
              f"{len(calls)} length groups, score/bits/runs max_abs_err "
              f"{err} (tolerance 0: exact), kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms")
        if err != 0:
            raise AssertionError("e2e kernel disagrees with its plain "
                                 "version")
        got = e2e.e2e_align_batch(pairs, mism, gapo, gape, dev)
        want = [align_end_to_end(p, t, mism, gapo, gape) for p, t in pairs]
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want))
                       if g != w)
            raise AssertionError(f"e2e CIGAR differs from the host aligner "
                                 f"on pair {bad}: {pairs[bad]}")
        print(f"e2e fuzz ({mism},{gapo},{gape}): scores and CIGARs == "
              f"align_host.align_end_to_end on all {n_pairs} pairs")


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


def run_genotype(dsdir: str, reads: str, device: str, preset: str):
    from trgt_tpu_torch.cli import main
    from trgt_tpu_torch.engine import pipeline
    from trgt_tpu_torch.kernels import e2e
    prefix = os.path.join(dsdir, f"smoke_{preset}_{device}")
    pipeline.STAGE_TIMES.clear()
    e2e.routed.clear()
    t0 = time.perf_counter()
    rc = main(["genotype", "--genome", os.path.join(dsdir, "ref.fasta"),
               "--repeats", os.path.join(dsdir, "repeats.bed"),
               "--reads", os.path.join(dsdir, reads), "--preset", preset,
               "--output-prefix", prefix, "--device", device])
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"genotype --preset {preset} --device {device} "
                           f"exited {rc}")
    stages = {k: round(v, 3) for k, v in pipeline.STAGE_TIMES.items()}
    print(f"genotype --preset {preset} --device {device}: {N_LOCI} loci in "
          f"{elapsed:.3f} s = {N_LOCI / elapsed:.3f} loci/s; stages (s) "
          f"{json.dumps(stages)}", flush=True)
    if device == "cuda":
        print(f"consensus alignments routed in this run (host_seconds: "
              f"wall time of the host-routed ones, on a thread pool): "
              f"{json.dumps(dict(e2e.routed))}")
    return prefix


def drive_path(dsdir, reads, preset, expect):
    """Genotype with --device cuda (kernel inputs captured, launch counts
    set to 0 just before and read just after) and --device host; the two
    must write identical records and every kernel in `expect` must have
    been launched. Returns (launches, captures)."""
    table = kernel_table()
    caps = {name: Capture(k["module"], k["fn"]) for name, k in table.items()}
    # the (hmms, queries) of every Viterbi call, for the plain version's
    # own tables
    caps["viterbi_batches"] = Capture(table["viterbi"]["module"],
                                      "prepare_batch")
    with contextlib.ExitStack() as stack:
        for cap in caps.values():
            stack.enter_context(cap)
        for k in table.values():
            k["module"].launches = 0
        cuda_prefix = run_genotype(dsdir, reads, DEVICE, preset)
        launches = {name: k["module"].launches for name, k in table.items()}
    print(f"kernel launches in the {preset} cuda run: {json.dumps(launches)}")
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
    return launches, caps


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


def replay(path, table, caps):
    """Every kernel launched on `path` against its plain version on the
    inputs the cuda run gave it; {kernel name: numbers of this replay}.
    Time and bound cover every call, and every call is held: the Viterbi
    calls over REPLAY_MAX_L through `hold_rows`, all else call by call."""
    phase(f"replay: the {path} path's kernel inputs, kernel vs plain")
    out = {}
    for name, k in table.items():
        calls = caps[name].calls
        if not calls:
            continue
        kernel = getattr(k["module"], k["fn"])
        t0 = time.perf_counter()
        extra = {}
        if name == "viterbi":
            batches = [(a[0], a[1]) for a in caps["viterbi_batches"].calls]
            if [len(q) for _, q in batches] != [a[0].shape[0] for a in calls]:
                raise AssertionError("the captured Viterbi batches do not "
                                     "pair with the kernel's calls")
            own = [i for i, a in enumerate(calls)
                   if a[0].shape[1] <= REPLAY_MAX_L]
            rest = [i for i in range(len(calls)) if i not in own]
            err, _, plain_ms = compare(
                kernel, k["plain"], [calls[i] for i in own],
                dense_calls([batches[i] for i in own]))
            if rest:
                err_rows, ms_rows = hold_rows(
                    kernel, k["plain"], [calls[i] for i in rest],
                    [batches[i] for i in rest])
                err, plain_ms = max(err, err_rows), plain_ms + ms_rows
            ms = kernel_ms(kernel, calls)
            prev_calls = [a for a in calls if a[0].shape[1] <= PREV_MAX_L]
            extra = {"held_in_one_plain_batch": len(rest),
                     "ms_prev_calls": kernel_ms(kernel, prev_calls),
                     "prev_calls": len(prev_calls)}
        else:
            err, ms, plain_ms = compare(kernel, k["plain"], calls)
        bound, bound_by, n_bytes, n_ops = bound_ms(kernel, k["work"], calls,
                                                   k.get("io_bytes"))
        print(f"{name}: {len(calls)} {path}-path calls timed and held "
              f"against the plain version in "
              f"{time.perf_counter() - t0:.1f} s: max_abs_err {err} "
              f"(tolerance 0), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound:.6f} ms by {bound_by} ({n_bytes} bytes, "
              f"{n_ops:.0f} operations)", flush=True)
        if extra:
            print(f"viterbi: the {extra['held_in_one_plain_batch']} calls "
                  f"over {REPLAY_MAX_L} positions held row by row against "
                  f"one plain batch of their rows, none left unheld; kernel "
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
    wgs_launches, caps = drive_path(dsdir, "reads.bam", "wgs",
                                    ("flank", "viterbi", "e2e"))
    wgs = replay("wgs", table, caps)
    del caps

    phase(f"targeted path: bench{N_LOCI} catalog, every second read rq "
          f"0.85, --preset targeted, --device cuda vs host")
    reads = low_quality_reads(dsdir)
    launches, caps = drive_path(dsdir, reads, "targeted", tuple(table))
    targeted = replay("targeted", table, caps)

    kernels = []
    for name, k in table.items():
        entry = {"name": name, "route": "cuda", "source": k["source"],
                 "replaces": k["replaces"], "launches": launches[name],
                 **targeted[name]}
        if "also_replaces" in k:
            entry["also_replaces"] = k["also_replaces"]
        if name in wgs:
            entry["wgs_path"] = {"launches": wgs_launches[name], **wgs[name]}
        kernels.append(entry)
    return kernels


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
    kernels = phase_paths()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(gpu_name_power())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
