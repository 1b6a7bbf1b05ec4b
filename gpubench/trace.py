"""What a run reads besides the records: the workers' own log lines, the
device trace of a `--trace 1` run, and the cards' memory.

- `worker_lines`: each worker's `worker ready <s>` and `worker done <s>:
  <n> loci, stages {..}, counts {..}, routed {..}, cuda memory {..},
  kernels {..}` lines (engine/worker.py, logged at -vv).
- `DeviceTrace`: the events traced_worker.py wrote, folded into the
  seconds each card was busy inside the window, the device operations
  that took most of it and the longest idle gaps.
- `MemorySampler`: `nvidia-smi` memory.used of every card, sampled
  through the run; the peak of the fullest card.
- `CpuClock`: each process's CPU seconds, read as the window opens and
  as it closes, for the log.
"""

import glob
import json
import os
import re
import subprocess
import threading
from collections import Counter, defaultdict

import numpy as np

_READY = re.compile(r"\[worker (\d+)\] DEBUG worker ready ([\d.]+) s")
_DONE = re.compile(r"\[worker (\d+)\] DEBUG worker done ([\d.]+) s after "
                   r"spawn: (\d+) loci, ")


def worker_lines(log_path: str) -> dict:
    """{worker: {"ready_s", "done_s", "loci", "stages", "counts",
    "routed", "cuda_memory", "kernels"}} from a run's worker log."""
    out = defaultdict(dict)
    dec = json.JSONDecoder()
    with open(log_path, errors="replace") as fh:
        for line in fh:
            m = _READY.search(line)
            if m:
                out[int(m.group(1))]["ready_s"] = float(m.group(2))
                continue
            m = _DONE.search(line)
            if not m:
                continue
            w = out[int(m.group(1))]
            w["done_s"], w["loci"] = float(m.group(2)), int(m.group(3))
            pos = m.end()
            for key, label in (("stages", "stages "), ("counts", "counts "),
                               ("routed", "routed "),
                               ("cuda_memory", "cuda memory "),
                               ("kernels", "kernels ")):
                pos = line.index(label, pos) + len(label)
                w[key], pos = dec.raw_decode(line, pos)
    return dict(out)


def short_name(name: str) -> str:
    """A kernel's name without its parameter list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for k in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[k], 0)
        if depth == 0:
            return name[:k].rstrip() if k else name
    return name


def _union(starts, ends):
    """Disjoint intervals covering the given ones, sorted."""
    order = np.argsort(starts)
    merged = []
    for s, e in zip(starts[order], ends[order]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class DeviceTrace:
    def __init__(self, trace_dir: str, t0: float, t1: float):
        """Events of every traced worker, clipped to the window [t0, t1]
        on the host's wall clock."""
        self.t0, self.t1 = t0, t1
        self.workers = []
        for path in sorted(glob.glob(f"{trace_dir}/worker*.npz")):
            with np.load(path) as z:
                self.workers.append({k: z[k] for k in z.files})

    def __bool__(self):
        return bool(self.workers)

    def _window_events(self):
        for w in self.workers:
            s = np.clip(w["start"], self.t0, self.t1)
            e = np.clip(w["start"] + w["dur"], self.t0, self.t1)
            keep = e > s
            yield w, s[keep], e[keep], w["name"][keep]

    def busy_s(self) -> float:
        """Seconds in which an operation ran on a card, averaged over the
        cards the workers used."""
        by_card = defaultdict(lambda: ([], []))
        for w, s, e, _ in self._window_events():
            by_card[int(w["card"])][0].append(s)
            by_card[int(w["card"])][1].append(e)
        if not by_card:
            return 0.0
        total = 0.0
        for starts, ends in by_card.values():
            merged = _union(np.concatenate(starts), np.concatenate(ends))
            total += sum(e - s for s, e in merged)
        return total / len(by_card)

    def device_ops(self, k: int = 10):
        """[name, seconds] of the operations that took most device time
        in the window, summed over the workers."""
        tot = Counter()
        for w, s, e, name in self._window_events():
            per = np.zeros(len(w["names"]))
            np.add.at(per, name, e - s)
            for n, v in zip(w["names"], per):
                if v:
                    tot[short_name(str(n))] += float(v)
        return [[n, v] for n, v in tot.most_common(k)]

    def idle_gaps(self, k: int = 10):
        """[label, seconds] of the card's idle time in the window, summed
        by the operation that ran last before each gap ("after <op>"),
        longest first; first card."""
        spans = []
        for w, s, e, name in self._window_events():
            if int(w["card"]) == int(self.workers[0]["card"]):
                spans.extend(zip(s, e, (short_name(str(w["names"][n]))
                                        for n in name)))
        spans.sort()
        gaps = Counter()
        end, last = self.t0, "window open"
        for s, e, n in spans:
            if s > end:
                gaps[f"after {last}"] += s - end
            if e >= end:
                end, last = e, n
        if self.t1 > end:
            gaps[f"after {last}"] += self.t1 - end
        return [[n, float(v)] for n, v in gaps.most_common(k)]

    def max_reserved(self) -> int:
        return max(int(w["max_reserved"]) for w in self.workers)


class MemorySampler:
    """`nvidia-smi` memory.used of every card every 500 ms, read as it
    writes (a pipe left unread stops it)."""

    def __init__(self):
        self.peak_mib = Counter()
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=index,memory.used",
             "--format=csv,noheader,nounits", "-lms", "500"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                idx, mib = (int(x) for x in line.split(","))
            except ValueError:
                continue
            self.peak_mib[idx] = max(self.peak_mib[idx], mib)

    def stop(self) -> int:
        """The fullest card's peak, in bytes."""
        self.proc.terminate()
        self.proc.wait()
        self.thread.join(timeout=5)
        self.proc.stdout.close()
        return max(self.peak_mib.values(), default=0) * 2**20


def _cpu_seconds(pid) -> float:
    """User and system CPU seconds of process `pid` so far."""
    with open(f"/proc/{pid}/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class CpuClock:
    """CPU seconds of each watched process between `start` and `stop`
    (Linux /proc; elsewhere nothing)."""

    def __init__(self):
        self.pids = {}
        self.t0 = self.t1 = None

    def _read(self):
        try:
            return {name: _cpu_seconds(pid)
                    for name, pid in self.pids.items()}
        except (OSError, ValueError, IndexError):
            return None

    def start(self, pids: dict) -> None:
        self.pids = dict(pids)
        self.t0 = self._read()

    def stop(self) -> None:
        self.t1 = self._read()

    def summary(self):
        """{name: CPU seconds} over the window; None where either end was
        not read."""
        if self.t0 is None or self.t1 is None:
            return None
        return {k: round(self.t1[k] - self.t0[k], 2)
                for k in self.t0 if k in self.t1}
