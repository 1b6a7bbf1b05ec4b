"""Device busy share of one `genotype --device cuda` run of the port.

    python3 chip_profile.py [wgs|targeted]
    python3 chip_profile.py scaling
    python3 chip_profile.py streams

`scaling` times the two kernels whose cost is latency between serial
steps, alone, at shapes that take that cost apart: the Viterbi kernel on
one to 128 rows of 4000 bases over motifs of 1 to 30 bases (the silent
chain per position grows with the motif), as ns per position; the flank
kernel on 512 problems at every padded width from 64 to 16384 columns
(pattern 250), as ns per row and ps per cell. `streams` records the
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
