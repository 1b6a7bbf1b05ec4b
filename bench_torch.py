"""Bench of the PyTorch/CUDA port (trgt_tpu_torch): `genotype` timed as a
user runs it, on one NVIDIA GPU.

    python3 bench_torch.py [--cell NAME|all] [--seed 42] [--repeats N]
        [--loci N] [--data-root DIR] [--deadline-s S] [--device cuda|cpu]

Cells (`--cell all` runs them in this order):

  bench96-wgs       cached_hetero_dataset(96, seed), reads.bam, --preset
                    wgs, in this process after one warm call (the kernels'
                    build included); 5 runs. WGS callers; every kernel of
                    the wgs path (flank, Viterbi, both e2e classes).
  bench96-targeted  the same catalog, every second read at rq 0.85
                    (chip_smoke.low_quality_reads), --preset targeted, in
                    this process; 5 runs. Capture and amplicon panels; all
                    four kernels.
  scale10k-wgs-t4   cached_hetero_dataset(10000, seed, tag="scale"), as a
                    child `python -m trgt_tpu_torch -vv genotype -t 4`; 3
                    runs. The JAX package's own scale point; the worker
                    pool.
  targeted2500-t4   cached_hetero_dataset(2500, seed, tag="targeted2500"),
                    every second read at rq 0.85, a child at --preset
                    targeted -t 4; 3 runs. A large targeted panel; the
                    edit-distance kernel at scale.

Each catalog is made by a child process (chip_smoke.start_generator) under
`--data-root` (default chip_smoke.DATA_ROOT); its time is `data_s`, set-up
outside every metric. `--loci N` takes the first N catalog lines.
`--repeats` overrides the number of runs. Outputs go under `bench/` beside
the data root (build/trgt_tpu_torch/bench by default, gitignored).

The in-process cells run `cli.main` several times in one process. Before
each run the stage seconds, the kernel counters and `e2e.routed` are set
to 0. The HMM cache (`engine/workflow.py cached_hmm`) is not cleared: every
timed run finds the topologies of the warm call built, as a user's second
catalog in one process would.

A host anchor is measured in the same call before the timed runs: the
port's `--device host` at the cell's `-t` and preset, on the whole catalog
for bench96 and on every 16th catalog line for the two large cells
(`host_loci_per_s`, start-up included for the child cells; `vs_host` is
the median loci/s over it).

Output: one JSON line per measured run ("kind": "run"), each followed by
the cell's result line ("kind": "result") with "partial": true; the last
line of a cell is its result, after one more run under `torch.profiler`
for the in-process cells (kept apart from the timed runs: device
milliseconds by kernel name and the busy share from the union of device
intervals). A result holds:

  loci_per_s     median, p25, p75 over the timed runs, n_runs
  wall_s, setup_s (the warm call in process; the slowest worker's ready
                 seconds after its spawn for a child run), data_s
  failed_loci    catalog lines without a VCF record, of those attempted
  correct        every run: at seed 42 on the full catalog the md5s of
                 trgt_tpu's records pinned in chip_smoke.RUN_MD5 (after
                 the generated files' chip_smoke.FILE_MD5); otherwise the
                 truth AL of every error-free locus (chip_smoke.
                 truth_check) and at least one such locus. Always: the
                 anchor's records equal the run's on the anchor's loci,
                 and no catalog line failed
  stages         summed STAGE_TIMES of the median run (the workers' sums
                 for a child run)
  kernels        per kernel of the median run (kernels/telemetry.py):
                 launches, calls, cells, bytes in and out, bound_ms
  e2e_routed, busy_share (mean utilization.gpu of nvidia-smi samples
                 over the run), memory_used_mib (peak memory.used),
                 rss_mib (peak RSS of this or the genotype process and of
                 the largest worker, from /proc)
  profile        the profiled run (in-process cells on the card)
  host_loci_per_s, vs_host, anchor
  card           {"name", "power_limit_w", "count"} from nvidia-smi

There is no fallback to another path: without a card, and without an
explicit `--device cpu`, the script exits non-zero and prints no rate; a
failed build, launch or run raises. A `--device cpu` run says "platform":
"cpu" on every line and writes null for the busy share, the device memory,
the profile and the card. The exit code is 0 only when every requested
cell ran all its runs and is correct. `--deadline-s` (default 3300) is a
wall-clock limit for the whole script: each child's timeout is derived
from the time that remains, and a run that would not fit is not started
(its cell's result then says "cut_by_deadline").

Imports nothing of JAX or of trgt_tpu.
"""

import argparse
import collections
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import chip_smoke as cs

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 42
DEADLINE_S = 3300.0
# seconds kept back from a child's timeout for what follows it
MARGIN_S = 30.0

Cell = collections.namedtuple(
    "Cell", "n tag preset low_rq threads child runs anchor_stride")
CELLS = {
    "bench96-wgs": Cell(cs.N_LOCI, f"bench{cs.N_LOCI}", "wgs", False, 1,
                        False, 5, 1),
    "bench96-targeted": Cell(cs.N_LOCI, f"bench{cs.N_LOCI}", "targeted",
                             True, 1, False, 5, 1),
    "scale10k-wgs-t4": Cell(cs.SCALE_LOCI, "scale", "wgs", False,
                            cs.SCALE_THREADS, True, 3, 16),
    "targeted2500-t4": Cell(cs.TARGETED_SCALE_LOCI, cs.TARGETED_SCALE_TAG,
                            "targeted", True, cs.SCALE_THREADS, True, 3, 16),
}


def emit(payload: dict) -> None:
    print(json.dumps(payload), flush=True)


def card():
    """{"name", "power_limit_w", "count"} of the card, from nvidia-smi."""
    import torch
    name, limit = [x.strip() for x in cs.gpu_name_power().splitlines()[0]
                   .split(",")]
    return {"name": name, "power_limit_w": float(limit.split()[0]),
            "count": torch.cuda.device_count()}


def quartiles(values):
    """{"median", "p25", "p75", "n_runs"} of the values."""
    values = sorted(values)
    if len(values) == 1:
        q = [values[0]] * 3
    else:
        q = statistics.quantiles(values, n=4, method="inclusive")
    return {"median": q[1], "p25": q[0], "p75": q[2], "n_runs": len(values)}


def write_bed(dsdir: str, name: str, lines) -> str:
    with open(os.path.join(dsdir, name), "w") as fh:
        fh.writelines(lines)
    return name


def kernel_numbers(snap):
    """Per kernel of a telemetry snapshot (`totals`, and the two e2e
    classes): the counters and the bound."""
    from trgt_tpu_torch.kernels import telemetry
    out = {}
    for name, c in {**telemetry.totals(snap),
                    **{k: v for k, v in snap.items()
                       if k.startswith("e2e_")}}.items():
        bound, by = telemetry.bound_ms(name, c)
        out[name] = {"launches": c.get("launches", 0),
                     "calls": c.get("calls", 0), "cells": c.get("cells", 0),
                     "bytes_in": c.get("bytes_in", 0),
                     "bytes_out": c.get("bytes_out", 0),
                     "bound_ms": bound, "bound_by": by}
    return out


def summed(dicts):
    out = collections.Counter()
    for d in dicts:
        out.update(d)
    return dict(out)


class Bench:
    def __init__(self, args):
        self.args = args
        self.device = args.device
        self.on_card = args.device == "cuda"
        self.platform = "gpu" if self.on_card else "cpu"
        self.t_end = time.perf_counter() + args.deadline_s
        self.out_dir = os.path.join(
            os.path.dirname(os.path.abspath(args.data_root)), "bench")
        os.makedirs(self.out_dir, exist_ok=True)
        self.card = card() if self.on_card else None

    def remaining(self) -> float:
        return self.t_end - time.perf_counter()

    # ---- data ----
    def dataset(self, cell):
        """(folder, catalog, reads, loci, pinned, seconds to make)."""
        t0 = time.perf_counter()
        generator = cs.start_generator(cell.n, cell.tag, cell.low_rq,
                                       seed=self.args.seed,
                                       root=self.args.data_root)
        try:
            dsdir = cs.wait_generator(generator, cell.tag,
                                      timeout=max(self.remaining(), 1))
        finally:
            if generator[0].poll() is None:
                generator[0].kill()
                generator[0].wait()
        data_s = time.perf_counter() - t0
        reads = cs.LOW_RQ_READS if cell.low_rq else "reads.bam"
        with open(os.path.join(dsdir, "repeats.bed")) as fh:
            lines = fh.readlines()
        bed, n = "repeats.bed", len(lines)
        if self.args.loci is not None and self.args.loci < n:
            n = self.args.loci
            bed = write_bed(dsdir, f"repeats_first{n}.bed", lines[:n])
        pinned = self.args.seed == cs.SEED and n == cell.n
        if pinned:
            cs.check_files(cell.tag, dsdir)
        return dsdir, bed, reads, n, pinned, data_s

    # ---- one genotype run ----
    def run(self, cell, dsdir, bed, reads, name, device=None,
            profiled=False):
        """One `genotype` of the catalog `bed`: in this process, or as a
        child where the cell says so. Returns {"prefix", "wall_s",
        "stages", "kernels" (telemetry snapshot), "routed", "setup_s",
        "busy_share", "memory_used_mib", "rss_mib", "profile"}."""
        device = device or self.device
        prefix = os.path.join(self.out_dir, name)
        argv = ["genotype", "--genome", os.path.join(dsdir, "ref.fasta"),
                "--repeats", os.path.join(dsdir, bed),
                "--reads", os.path.join(dsdir, reads),
                "--preset", cell.preset, "--output-prefix", prefix,
                "--device", device, "-t", str(cell.threads)]
        gpu = self.on_card
        with cs.RunSampler(gpu=gpu) as sampler:
            time.sleep(0.3)
            if cell.child:
                out = self._child(argv, cell.threads, sampler)
            else:
                sampler.watch(os.getpid())
                out = self._inproc(argv, device, profiled)
        t0, t1 = out.pop("window")
        window = [(m, b) for t, m, b in sampler.smi_series if t0 <= t <= t1]
        out.update(
            prefix=prefix,
            busy_share=(sum(b for _, b in window) / len(window) / 100
                        if gpu and window else None),
            memory_used_mib=(max(m for m, _ in window)
                             if gpu and window else None),
            rss_mib=sampler.peak_rss())
        return out

    def _inproc(self, argv, device, profiled):
        import torch
        from trgt_tpu_torch.cli import main
        from trgt_tpu_torch.kernels import e2e, telemetry
        from trgt_tpu_torch.utils import recorder
        recorder.STAGE_TIMES.clear()
        recorder.STAGE_COUNTS.clear()
        telemetry.clear()
        e2e.routed.clear()
        ctx = contextlib.nullcontext()
        if profiled:
            from torch.profiler import ProfilerActivity, profile
            ctx = profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
        with ctx as prof:
            t0 = time.perf_counter()
            rc = main(argv)
            if device == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        if rc != 0:
            raise RuntimeError(f"genotype {' '.join(argv[-7:])} exited {rc}")
        out = {"window": (t0, t1), "wall_s": t1 - t0,
               "stages": dict(recorder.STAGE_TIMES),
               "kernels": telemetry.snapshot(), "routed": dict(e2e.routed),
               "setup_s": None, "profile": None}
        if prof is not None:
            out["profile"] = self._profile(prof, t1 - t0)
        return out

    def _profile(self, prof, wall):
        """Device ms by kernel name and the busy share of a profiled run
        (chip_profile.py's device intervals)."""
        import chip_profile
        with tempfile.TemporaryDirectory(dir=self.out_dir) as td:
            path = os.path.join(td, "trace.json")
            prof.export_chrome_trace(path)
            intervals = chip_profile.device_intervals(path)
        by_name = collections.Counter()
        for start, end, name in intervals:
            by_name[name] += (end - start) / 1e3
        busy_ms = chip_profile.union_us(intervals) / 1e3
        return {"wall_s": wall, "device_ms": sum(by_name.values()),
                "busy_ms": busy_ms, "busy_share": busy_ms / 1e3 / wall,
                "device_ms_by_kernel": dict(by_name.most_common())}

    def _child(self, argv, threads, sampler):
        timeout = self.remaining() - MARGIN_S
        if timeout <= 0:
            raise TimeoutError("no time left for a child run")
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "trgt_tpu_torch", "-vv", *argv]
        t0 = time.perf_counter()
        with subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) as proc:
            sampler.watch(proc.pid)
            try:
                stderr = proc.communicate(timeout=timeout)[1]
            except subprocess.TimeoutExpired:
                proc.kill()
                raise
        t1 = time.perf_counter()
        if proc.returncode != 0:
            raise RuntimeError(f"genotype -t {threads} exited "
                               f"{proc.returncode}:\n{stderr[-4000:]}")
        pool = "worker pool:" in stderr
        workers = cs.worker_lines(stderr, threads) if pool else {}
        kernels = collections.defaultdict(collections.Counter)
        for w in workers.values():
            for cls, c in w["kernels"].items():
                kernels[cls].update(c)
        return {"window": (t0, t1), "wall_s": t1 - t0,
                "stages": summed(w["stages"] for w in workers.values())
                if pool else None,
                "kernels": {k: dict(v) for k, v in kernels.items()},
                "routed": summed(w["routed"] for w in workers.values()),
                "setup_s": max((w["ready"] for w in workers.values()),
                               default=None),
                "profile": None}

    # ---- correctness ----
    def check(self, cell, dsdir, prefix, n_loci, pinned, anchor):
        """{"correct", "pins", "truth", "anchor", "failed_loci"} of a run
        (`anchor`: (prefix, stride) of the host anchor)."""
        vcf, bam = cs.records(prefix)
        n_rec = sum(1 for line in vcf.splitlines()
                    if not line.startswith("#"))
        failed = {"failed": n_loci - n_rec, "attempted": n_loci}
        out = {"failed_loci": failed, "pins": None, "truth": None}
        if pinned:
            out["pins"] = pins_match(
                prefix, cs.RUN_MD5[(cell.tag, cell.preset, "host")])
            ok = out["pins"]
        else:
            with open(os.path.join(dsdir, "truth.json")) as fh:
                n, failures = cs.truth_check(vcf, json.load(fh))
            out["truth"] = {"checked": n, "failed": len(failures)}
            ok = n > 0 and not failures
        out["anchor"] = anchor_match((vcf, bam), cs.records(anchor[0]),
                                     anchor[1] == 1)
        out["correct"] = bool(ok and out["anchor"] and failed["failed"] == 0)
        return out

    # ---- a cell ----
    def cell(self, name):
        cell = CELLS[name]
        runs = self.args.repeats or cell.runs
        dsdir, bed, reads, n_loci, pinned, data_s = self.dataset(cell)
        base = {"cell": name, "platform": self.platform, "card": self.card,
                "device": self.device, "seed": self.args.seed,
                "loci": n_loci, "threads": cell.threads,
                "preset": cell.preset, "runs_asked": runs,
                "correct_by": ("pins" if pinned else "truth") + " and anchor"}
        setup = None
        if not cell.child:
            warm = self.run(cell, dsdir, bed, reads, f"{name}_warm")
            setup = warm["wall_s"]

        # the host anchor: the whole catalog, or every anchor_stride-th line
        with open(os.path.join(dsdir, bed)) as fh:
            lines = fh.readlines()
        anchor_bed = bed if cell.anchor_stride == 1 else write_bed(
            dsdir, f"{bed[:-4]}_stride{cell.anchor_stride}.bed",
            lines[::cell.anchor_stride])
        n_anchor = len(lines[::cell.anchor_stride])
        host = self.run(cell, dsdir, anchor_bed, reads, f"{name}_host",
                        device="host")
        anchor = {"loci": n_anchor, "stride": cell.anchor_stride,
                  "wall_s": host["wall_s"],
                  "loci_per_s": n_anchor / host["wall_s"],
                  "stages": host["stages"]}

        measured, checks = [], []
        cut = False
        for i in range(runs):
            if measured and self.remaining() < \
                    1.5 * measured[-1]["wall_s"] + MARGIN_S:
                cut = True
                break
            r = self.run(cell, dsdir, bed, reads, f"{name}_run{i}")
            c = self.check(cell, dsdir, r["prefix"], n_loci, pinned,
                           (host["prefix"], cell.anchor_stride))
            measured.append(r)
            checks.append(c)
            emit({"kind": "run", **base, "run": i,
                  "loci_per_s": n_loci / r["wall_s"], **run_fields(r), **c})
            result = self.result(base, measured, checks, setup, data_s,
                                 anchor, None, partial=True, cut=False)
            emit(result)

        profile = None
        if self.on_card and not cell.child and not cut and \
                self.remaining() > 1.5 * measured[-1]["wall_s"] + MARGIN_S:
            p = self.run(cell, dsdir, bed, reads, f"{name}_profiled",
                         profiled=True)
            c = self.check(cell, dsdir, p["prefix"], n_loci, pinned,
                           (host["prefix"], cell.anchor_stride))
            checks.append(c)
            profile = p["profile"]
        elif self.on_card and not cell.child:
            cut = True
        result = self.result(base, measured, checks, setup, data_s, anchor,
                             profile, partial=cut, cut=cut)
        emit(result)
        return result["correct"] and not cut

    def result(self, base, measured, checks, setup, data_s, anchor, profile,
               partial, cut):
        n_loci = base["loci"]
        rates = [n_loci / r["wall_s"] for r in measured]
        # the layer numbers are the median run's
        order = sorted(range(len(measured)), key=lambda i: measured[i]["wall_s"])
        mid = measured[order[(len(order) - 1) // 2]]
        lps = quartiles(rates)
        if setup is None:
            ready = [r["setup_s"] for r in measured
                     if r["setup_s"] is not None]
            setup = statistics.median(ready) if ready else None
        bad = [c for c in checks if not c["correct"]]
        return {
            "kind": "result", **base,
            "metric": "loci_per_s", "loci_per_s": lps,
            "wall_s": {"median": statistics.median(
                r["wall_s"] for r in measured),
                "runs": [r["wall_s"] for r in measured]},
            "setup_s": setup, "data_s": data_s,
            "failed_loci": {
                "failed": max(c["failed_loci"]["failed"] for c in checks),
                "attempted": n_loci},
            "correct": not bad, "checks": (bad or checks)[-1],
            **run_fields(mid),
            "profile": profile,
            "host_loci_per_s": anchor["loci_per_s"],
            "vs_host": lps["median"] / anchor["loci_per_s"],
            "anchor": anchor,
            "partial": partial, "cut_by_deadline": cut}


def run_fields(r):
    """A run's layer numbers, as printed."""
    return {"wall_s_run": r["wall_s"], "setup_s_run": r["setup_s"],
            "stages": r["stages"], "kernels": kernel_numbers(r["kernels"]),
            "e2e_routed": r["routed"], "busy_share": r["busy_share"],
            "memory_used_mib": r["memory_used_mib"],
            "rss_mib": r["rss_mib"]}


def pins_match(prefix: str, pin) -> bool:
    """The (VCF body, spanning-BAM records) md5s of a run == `pin`, a pair
    of chip_smoke.RUN_MD5."""
    return cs.records_md5(prefix) == tuple(pin)


def anchor_match(run, anchor, whole: bool) -> bool:
    """The anchor's records equal the run's on the anchor's loci: its VCF
    lines are the run's lines of those loci (header included), and its
    spanning-BAM records the run's (`whole`: the same catalog) or among
    them."""
    (vcf, bam), (a_vcf, a_bam) = run, anchor
    ids = {m[1] for m in re.finditer(r"TRID=([^;\t]+)", a_vcf)}
    lines = [line for line in vcf.splitlines()
             if line.startswith("#")
             or re.search(r"TRID=([^;\t]+)", line)[1] in ids]
    if not ids or lines != a_vcf.splitlines():
        return False
    if whole:
        return bam == a_bam
    return not collections.Counter(cs.bam_records(a_bam)) - \
        collections.Counter(cs.bam_records(bam))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="all", choices=["all", *CELLS])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--loci", type=int, default=None)
    ap.add_argument("--data-root", default=cs.DATA_ROOT)
    ap.add_argument("--deadline-s", type=float, default=DEADLINE_S)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is false (pass "
              "--device cpu to run the plain versions)", file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    bench = Bench(args)
    names = list(CELLS) if args.cell == "all" else [args.cell]
    ok = True
    for name in names:
        ok = bench.cell(name) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
