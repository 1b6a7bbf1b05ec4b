"""Device busy share of one `genotype --device cuda` run of the port.

    python3 chip_profile.py [wgs|targeted]
    python3 chip_profile.py scaling
    python3 chip_profile.py streams

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
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs


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
        launches = vt.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for hmms, queries, _dev in calls:
            vt.viterbi_batch_multi(hmms, queries, dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, vt.launches - launches

    many = vt.MAX_STREAMS
    replay_all(many)                                    # warm
    for n_streams in (many, 1, 1, many, many, 1):
        seconds, launches = replay_all(n_streams)
        print(f"  up to {n_streams:2d} streams: {seconds * 1e3:9.3f} ms for "
              f"{launches} launches")
    vt.MAX_STREAMS = many


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    preset = sys.argv[1] if len(sys.argv) > 1 else "targeted"
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if preset in ("scaling", "streams"):
        print(cs.gpu_name_power())
        (scaling if preset == "scaling" else streams)()
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
