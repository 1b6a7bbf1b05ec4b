"""One run of one cell of BENCHMARK.json (see run.py for the command).

Set-up: the cell's inputs from the seed (synth.py) under TMPDIR, then
`genotype -t N --device cuda` with the cell's preset, through the
program's own `run_genotype`, whose worker pool is window.WindowPool.
Set-up ends when every worker has delivered its first batch; the window
then counts the records the pool's merge writes for `--seconds`.
After it the pool gets no more chunks, the workers finish what they hold
and end their streams, and the records of the sampled loci that the
pool's merge wrote inside the window are judged by the plain reference
(reference.py).
"""

import argparse
import importlib
import json
import logging
import os
import shutil
import sys
import tempfile
import time

from . import reference, synth, trace, window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "trgt_tpu"}


def load_cell(name: str, root: str = ROOT):
    """(manifest, cell, configuration, mix) of cell `name`: the
    configuration from its entry's file, the mix from
    gpubench/mixes/<traffic>.json, both under `root`."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "gpubench", "mixes",
                           cell["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    return bench, cell, cfg, mix


def preset_params(cfg: dict) -> dict:
    """The gates and the genotyper of the configuration's preset (TRGT
    cli.rs:294-344)."""
    wgs = cfg["preset"] == "wgs"
    return {"min_read_qual": 0.98 if wgs else -1.0,
            "genotyper": "size" if wgs else "cluster"}


def sample_ids(ds, mix: dict, seed: int) -> set:
    """Base loci whose records are judged: a share drawn from the seed,
    and the locus with the longest allele of every block."""
    rng = synth.rng_for(seed, 4)
    ids = {lc.id for lc in ds.loci if rng.random() < mix["check_share"]}
    block = mix["block"]
    for b in range(0, len(ds.loci), block):
        longest = max(ds.loci[b:b + block],
                      key=lambda lc: max(len(a) for a in lc.alleles))
        ids.add(longest.id)
    return ids


class Run:
    """What the per-layer readers read."""

    def __init__(self, workers, device_trace):
        self.workers = workers
        self.trace = device_trace
        self.loci = sum(w.get("loci", 0) for w in workers.values())


def judge_window(ds, win, params, limits):
    """(whether the window's records pass, the compared numbers over the
    sampled loci it wrote, loci that failed). A locus fails where the
    pool skipped it, or wrote it without a genotype though the reference
    has reads for it."""
    from . import bamio
    index = {lc.id: k for k, lc in enumerate(ds.loci)}
    failed = win.skipped + sum(
        1 for trid in win.no_genotype
        if reference.expected(ds, index[trid], params)[0])
    per_locus = []
    for trid, line, recs in win.kept:
        _, rec = reference.parse_vcf_line(line)
        if rec is None:
            continue              # judged above
        rec.spans = dict(bamio.parse_record(r) for r in recs)
        per_locus.append(reference.judge(ds, index[trid], rec, params))
    numbers = reference.fold(per_locus)
    ok = numbers["loci_checked"] > 0 and failed == 0 and all(
        numbers[k] <= v for k, v in limits.items())
    return ok, numbers, failed


def parse_args(argv):
    p = argparse.ArgumentParser(prog="gpubench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start=None, device="cuda", root=ROOT) -> int:
    """Run one cell once and print its result line; the exit code.
    `device` other than "cuda" skips the look for a card, and `root`
    points at another manifest (CPU tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    bench, cell, cfg, mix = load_cell(args.workload, root)
    if device == "cuda":
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            seen = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            print(f"gpubench: {args.workload} needs {cell['chips']} CUDA "
                  f"device(s); PyTorch sees {seen}", file=sys.stderr)
            return 2
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    try:
        return _run(args, bench, cell, cfg, mix, tmp, t_start, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, bench, cell, cfg, mix, tmp, t_start, device) -> int:
    from trgt_tpu_torch import cli
    from trgt_tpu_torch.engine import runner

    ds = synth.Dataset(cfg, mix, args.seed)
    # the window's loci at the mix's highest rate, and two rounds of the
    # base catalog for the first batches and what the workers hold at
    # the close
    lines = int(mix["max_loci_per_s"] * args.seconds) + 2 * len(ds.loci)
    paths = ds.write(tmp, lines)
    win = window.Window(args.seconds, sample_ids(ds, mix, args.seed), lines,
                        len(ds.loci))
    gargs = cli.build_parser().parse_args(
        ["genotype", "-g", paths["genome"], "-r", paths["reads"],
         "-b", paths["repeats"], "-o", os.path.join(tmp, "out"),
         "--preset", cfg["preset"], "-t", str(mix["threads"]),
         "--device", device])
    cli.apply_genotype_preset(gargs)
    trace_dir = os.path.join(tmp, "trace")
    os.makedirs(trace_dir)
    log_path = os.path.join(tmp, "workers.log")
    trgt_log = logging.getLogger("trgt")
    trgt_log.setLevel(logging.DEBUG if args.trace else logging.WARNING)
    saved = (runner.WorkerPool, runner._worker_argv)
    window.WindowPool.window = win
    runner.WorkerPool = window.WindowPool
    if args.trace:
        script = os.path.join(HERE, "traced_worker.py")
        runner._worker_argv = lambda spec: [
            sys.executable, script,
            os.path.join(trace_dir, f"worker{spec['worker_index']}.npz"),
            json.dumps(spec)]
    sampler = trace.MemorySampler() if device == "cuda" else None
    cpu = trace.CpuClock()
    win.on_open = lambda: cpu.start({"parent": os.getpid(), **win.pids})
    win.on_close = cpu.stop
    # the workers inherit stderr: their log lines go to the run's log
    err_fd = os.dup(2)
    with open(log_path, "wb") as log_fh:
        os.dup2(log_fh.fileno(), 2)
    failure = None
    try:
        runner.run_genotype(gargs)
    except Exception as e:          # reported below, with the log's end
        failure = e
    finally:
        os.dup2(err_fd, 2)
        os.close(err_fd)
        runner.WorkerPool, runner._worker_argv = saved
        peak = sampler.stop() if sampler else 0
    if failure is not None or win.t_open is None or win.exhausted:
        with open(log_path, errors="replace") as fh:
            sys.stderr.write(fh.read()[-4000:])
        why = failure or ("the catalog ran out inside the window"
                          if win.exhausted else "the window never opened")
        print(f"gpubench: run failed: {why}", file=sys.stderr)
        return 1
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"gpubench: modules loaded that the port may not use: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3

    setup_s = win.t_open - t_start
    limits = cfg["limits"]
    ok, numbers, failed = judge_window(ds, win, preset_params(cfg), limits)
    correct = ok and win.written > 0
    name = args.workload
    if args.trace:
        run = Run(trace.worker_lines(log_path),
                  trace.DeviceTrace(trace_dir, win.wall_open,
                                    win.wall_open + args.seconds))
        metrics = {}
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            value = importlib.import_module(
                f"gpubench.metrics.{m['name']}").read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        run = None
        values = {"loci_per_s": win.written / args.seconds,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if name in m.get("workloads", [name])}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": _device_name(device), "count": cell["chips"],
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win.written,
              "failed": failed, "metrics": metrics, "device": dev}
    if run is not None and run.trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = args.seconds
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    checks["failed"] = {"value": failed, "limit": 0}
    result["checks"] = checks
    print(f"gpubench: {name} seed {args.seed}: {win.delivered()} loci "
          f"genotyped and {win.written} written in {args.seconds} s; "
          f"judged {numbers['loci_checked']} loci "
          f"({numbers['alleles_unjudged']} alleles equal to neither true "
          f"allele, their annotation not judged)", file=sys.stderr)
    print(f"gpubench: loci delivered by the workers in each second of the "
          f"window: {win.per_second}", file=sys.stderr)
    print(f"gpubench: records merge wrote in each second of the window: "
          f"{win.written_per_second}", file=sys.stderr)
    print(f"gpubench: CPU seconds over the window: {cpu.summary()}",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def _device_name(device: str) -> str:
    if device != "cuda":
        return device
    import torch
    return torch.cuda.get_device_name(0)
