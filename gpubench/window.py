"""The measured window around the program's `genotype -t N` worker pool
(trgt_tpu_torch.engine.runner.WorkerPool).

`WindowPool` is the pool itself with three observations added: the
records each worker delivers (the first batch of every worker opens the
window), the records `merge` writes inside the window (they make the
rate and are judged), and an end to the chunk grants once the window
has closed, so that every worker finishes what it holds and ends its
stream as `genotype` ends it. The window opens once every worker has
delivered its first batch: the workers are up, their kernels loaded and
their first shapes run.

The rate counts the records `merge` writes, VCF line and spanning BAM
records, inside the window: all the work of `genotype`, the parent's
merge and writers included. The loci the workers deliver are counted
beside it, for the log.
"""

import struct
import threading
import time

from trgt_tpu_torch.engine import runner


class Window:
    """The window's clock (perf_counter seconds from `t_open` to
    `t_close`), the loci the workers delivered in each of its seconds,
    and what `merge` wrote inside it: its count, the loci it skipped in
    catalog order, the records without a genotype and the records of the
    sampled loci."""

    def __init__(self, seconds: float, sample_ids, catalog_lines: int,
                 base_loci: int):
        self.seconds = seconds
        self.base_loci = base_loci     # the catalog repeats TR0..TR<n-1>
        self.prev = None               # catalog index of the last record
        self.sample_ids = sample_ids
        self.catalog_lines = catalog_lines
        self.t_open = self.t_close = None
        self.wall_open = None          # time.time() at t_open
        self.written = 0               # records merge wrote in the window
        self.per_second = []           # loci delivered in each second
        self.written_per_second = []   # records merge wrote in each second
        self.on_open = self.on_close = None   # callbacks, set by the harness
        self.pids = {}                 # the workers' process ids
        self.lock = threading.Lock()
        self.skipped = 0               # loci skipped in catalog order
        self.no_genotype = []          # TRIDs of records without one
        self.kept = []                 # [TRID, VCF line, [BAM records]]
        self.exhausted = False         # the catalog ran out in the window

    def open(self, now: float) -> None:
        self.t_open, self.t_close = now, now + self.seconds
        self.wall_open = time.time()
        if self.on_open is not None:
            self.on_open()
        if self.on_close is not None:
            timer = threading.Timer(self.seconds, self.on_close)
            timer.daemon = True
            timer.start()

    def delivered(self) -> int:
        """Loci the workers delivered inside the window."""
        return sum(self.per_second)

    def is_open(self, now: float) -> bool:
        return self.t_open is not None and now < self.t_close


class _VcfTap:
    def __init__(self, inner, pool):
        self.inner, self.pool = inner, pool
        self.current = None

    def write_bytes(self, data: bytes) -> None:
        w = self.pool.window
        now = time.perf_counter()
        self.current = None
        start = data.index(b"TRID=") + 5
        trid = data[start:data.index(b";", start)].decode()
        k = int(trid[2:])
        skipped = 0 if w.prev is None else (k - w.prev - 1) % w.base_loci
        w.prev = k
        if w.is_open(now):
            w.written += 1
            sec = int(now - w.t_open)
            w.written_per_second.extend(
                [0] * (sec + 1 - len(w.written_per_second)))
            w.written_per_second[sec] += 1
            w.skipped += skipped
            if b"\t./.:" in data:
                w.no_genotype.append(trid)
            if trid in w.sample_ids:
                self.current = [trid, bytes(data), []]
                w.kept.append(self.current)
        self.inner.write_bytes(data)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _BamTap:
    def __init__(self, inner, vcf_tap):
        self.inner, self.vcf_tap = inner, vcf_tap

    def write_encoded(self, rec, rid, pos, ref_end) -> None:
        if self.vcf_tap.current is not None:
            self.vcf_tap.current[2].append(bytes(rec))
        self.inner.write_encoded(rec, rid, pos, ref_end)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class WindowPool(runner.WorkerPool):
    window: Window = None      # set by the harness before the run

    def __init__(self, args, nproc: int):
        self.delivered = [0] * nproc
        super().__init__(args, nproc)
        self.window.pids = {f"worker{i}": p.pid
                            for i, p in enumerate(self.procs)}

    def _read_frame(self, i):
        frame = super()._read_frame(i)
        if frame is None:
            return frame
        w = self.window
        now = time.perf_counter()
        with w.lock:
            self.delivered[i] += 1
            if w.t_open is None and all(self.delivered):
                w.open(now)
            elif w.is_open(now):
                sec = int(now - w.t_open)
                w.per_second.extend([0] * (sec + 1 - len(w.per_second)))
                w.per_second[sec] += 1
        return frame

    def _grant_chunk(self, i):
        w = self.window
        if w.t_close is not None and time.perf_counter() >= w.t_close:
            try:
                self.procs[i].stdin.write(struct.pack("<qq", 0, 0))
                self.procs[i].stdin.flush()
            except (BrokenPipeError, OSError):
                pass
            return
        if self.next_start >= w.catalog_lines:
            w.exhausted = True
        super()._grant_chunk(i)

    def merge(self, vcf_writer, bam_writer):
        tap = _VcfTap(vcf_writer, self)
        return super().merge(tap, _BamTap(bam_writer, tap))
