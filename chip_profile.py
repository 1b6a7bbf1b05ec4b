"""Device busy share of one `genotype --device cuda` run of the port.

    python3 chip_profile.py [wgs|targeted]

Builds the bench catalog of chip_smoke.py, warms the kernels with one
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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    preset = sys.argv[1] if len(sys.argv) > 1 else "targeted"
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
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
