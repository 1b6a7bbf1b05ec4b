"""The port's span recorder (trgt_tpu_torch/utils/recorder.py): per-name
sums always, a bounded timeline of nested spans on the wall clock at
DEBUG, the span tables a `-t N` pool's workers send their parent, and the
benchmark's readers of them (gpubench/metrics/)."""

import importlib
import logging
import os
import sys
import threading
import time

import numpy as np
import pytest

from gpubench import harness, trace
from gpubench.metrics import device_idle_share
from gpubench.metrics.idle_extract_wait_share import NO_SPAN, idle_split
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.engine import runner as port_runner
from trgt_tpu_torch.utils import recorder
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset

NEW_READERS = ["extract_wait_ms_per_locus", "extract_inflate_ms_per_locus",
               "extract_decode_ms_per_locus", "extract_build_ms_per_locus",
               "extract_records_per_locus", "render_ms_per_locus",
               "release_ms_per_locus", "merge_write_ms_per_locus",
               "idle_extract_wait_share", "extract_inflated_mib_per_locus",
               "extract_block_hit_share"]
OUTPUTS = (".vcf.gz", ".spanning.bam")
N_LOCI = 12
MAIN_SPANS = {"extract_wait", "grant_wait", "render", "spans",
              "impure_filter", "genotype", "annotate", "assemble"}
EXTRACT_SPANS = {"extract", "extract.inflate", "extract.decode",
                 "extract.build"}


@pytest.fixture
def traced():
    """The recorder emptied, the `trgt` logger at DEBUG; both restored."""
    log = logging.getLogger("trgt")
    level = log.level
    recorder.clear()
    log.setLevel(logging.DEBUG)
    yield recorder
    log.setLevel(level)
    recorder.clear()


def by_name(events):
    out = {}
    for ev in events:
        out.setdefault(ev[1], []).append(ev)
    return out


def self_seconds(events) -> dict:
    """{span id: its duration minus the part of it that its child spans
    cover} over timeline events."""
    children = {}
    for sid, _, start, end, parent, _ in events:
        if parent is not None:
            children.setdefault(parent, []).append((start, end))
    out = {}
    for sid, _, start, end, _, _ in events:
        covered, reach = 0.0, start
        for c0, c1 in sorted(children.get(sid, ())):
            c0, c1 = max(c0, reach), min(c1, end)
            if c1 > c0:
                covered += c1 - c0
                reach = c1
        out[sid] = (end - start) - covered
    return out


def test_nested_spans_record_parents_and_self_time(traced):
    t_before = time.time()
    with recorder.timed("extract"):
        with recorder.timed("extract.inflate"):
            time.sleep(0.01)
        with recorder.timed("extract.decode"):
            time.sleep(0.01)
        time.sleep(0.01)
    t_after = time.time()
    ev = by_name(recorder.timeline())
    (ext,), (inf,), (dec,) = ev["extract"], ev["extract.inflate"], \
        ev["extract.decode"]
    assert ext[4] is None and inf[4] == ext[0] and dec[4] == ext[0]
    assert {e[5] for e in (ext, inf, dec)} == {"MainThread"}
    assert t_before <= ext[2] <= inf[2] < inf[3] <= dec[2] < dec[3] \
        <= ext[3] <= t_after
    own = self_seconds(recorder.timeline())
    children = (inf[3] - inf[2]) + (dec[3] - dec[2])
    assert own[ext[0]] == pytest.approx(ext[3] - ext[2] - children,
                                        abs=1e-9)
    assert own[ext[0]] >= 0.009
    assert own[inf[0]] == pytest.approx(inf[3] - inf[2], abs=1e-12)
    # the stamps are time.time() seconds, good to about 0.25 us
    assert recorder.STAGE_TIMES["extract"] == pytest.approx(
        ext[3] - ext[2], abs=1e-6)


def test_no_timeline_below_debug(traced):
    logging.getLogger("trgt").setLevel(logging.INFO)
    assert not recorder.tracing()
    with recorder.timed("render"):
        with recorder.timed("render"):
            pass
    recorder.count("extract_records", 7)
    assert recorder.timeline() == [] and recorder.dropped() == (0, 0)
    assert recorder.STAGE_TIMES["render"] > 0
    assert recorder.STAGE_COUNTS["extract_records"] == 7


def test_the_cap_counts_what_it_drops(traced, monkeypatch):
    monkeypatch.setattr(recorder, "MAX_EVENTS", 3)
    for _ in range(5):
        with recorder.timed("grant_wait"):
            pass
    assert len(recorder.timeline()) == 3 and recorder.dropped() == (2, 0)
    table = recorder.table(-1)
    assert table["dropped"] == 2 and table["dropped_nested"] == 0
    assert [r[0] for r in table["rows"]] == [-1] * 3
    recorder.clear()
    assert recorder.dropped() == (0, 0) and recorder.timeline() == []


def test_nested_spans_never_crowd_out_top_level_ones(traced, monkeypatch):
    """An extract's many parts fill their own store: every top-level
    span of the main thread is still kept."""
    monkeypatch.setattr(recorder, "MAX_EVENTS", 4)
    for _ in range(2):
        with recorder.timed("extract"):
            for _ in range(5):
                with recorder.timed("extract.inflate"):
                    pass
        with recorder.timed("extract_wait"):
            pass
    ev = by_name(recorder.timeline())
    assert len(ev["extract.inflate"]) == 4
    assert len(ev["extract"]) == 2 and len(ev["extract_wait"]) == 2
    assert recorder.dropped() == (0, 6)
    assert recorder.STAGE_TIMES.keys() == {"extract", "extract.inflate",
                                           "extract_wait"}


def test_threads_keep_their_own_spans_under_contention(traced):
    """More threads than cores, switching often: no event, sum or count
    is lost, and a span opened on one thread is no parent on another."""
    n_threads, n_spans = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recorder.timed("outer"):
            threads = [threading.Thread(target=_spans, args=(n_spans,))
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    ev = by_name(recorder.timeline())
    assert len(ev["inner"]) == n_threads * n_spans
    assert recorder.STAGE_COUNTS["n"] == n_threads * n_spans
    assert all(e[4] is None and e[5] != "MainThread" for e in ev["inner"])
    assert len({e[0] for e in ev["inner"]}) == n_threads * n_spans


def _spans(n):
    for _ in range(n):
        with recorder.timed("inner"):
            recorder.count("n")


# ---- the pipeline and the worker pool ----

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("torch_recorder"))
    # a dozen loci, so that both workers of a -t 2 pool can take some
    loci = [SynthLocus(f"T{i}", "CAG", 10 + i % 4, (10 + i % 4, 14 + i))
            for i in range(N_LOCI)]
    fasta, bed, bam = make_dataset(td, loci, depth=12, error_rate=0.01)
    return td, fasta, bed, bam


def test_pipeline_spans_and_record_count(dataset, traced):
    """`extract`'s parts are its children on the prefetch thread, the wait
    for it is on the main thread, and `extract_records` counts the records
    each locus's walk decoded, as the Python twin's fetch sees them."""
    from trgt_tpu_torch.engine.pipeline import BatchPipeline
    from trgt_tpu_torch.engine.workflow import Params
    from trgt_tpu_torch.io.bam import BamReader
    from trgt_tpu_torch.io.catalog import iter_loci
    from trgt_tpu_torch.io.fasta import FastaReader
    from trgt_tpu_torch.utils import Genotyper, Karyotype, TrgtScoring
    td, fasta, bed, bam = dataset
    params = Params(min_flank_id_frac=0.7, min_read_qual=0.98,
                    search_flank_len=250, max_depth=250,
                    aln_scoring=TrgtScoring(2, 5, 1))
    loci = list(iter_loci(bed, FastaReader(fasta), Karyotype.new("XX"), 250,
                          Genotyper.from_str("size")))
    got = list(BatchPipeline(params, None, batch_size=4).process(
        loci, BamReader(bam)))
    assert len(got) == N_LOCI
    events = recorder.timeline()
    ev = by_name(events)
    extract_ids = {e[0] for e in ev["extract"]}
    assert len(extract_ids) == N_LOCI // 4
    for part in ("extract.inflate", "extract.decode", "extract.build"):
        assert ev[part] and all(e[4] in extract_ids for e in ev[part])
    assert all(e[5] != "MainThread" for e in ev["extract"])
    for name in ("extract_wait", "spans", "genotype", "annotate",
                 "assemble"):
        assert len(ev[name]) == N_LOCI // 4
        assert all(e[5] == "MainThread" and e[4] is None for e in ev[name])
    assert "release" not in ev         # no card: nothing to release
    own = self_seconds(events)
    for e in ev["extract"]:
        kids = sum(c[3] - c[2] for c in events if c[4] == e[0])
        assert own[e[0]] == pytest.approx(e[3] - e[2] - kids, abs=1e-9)
    reader = BamReader(bam)
    want = sum(1 for locus in loci
               for rec in reader.fetch(locus.region.contig,
                                       max(0, locus.region.start - 250),
                                       locus.region.end + 250)
               if not (rec.is_secondary or rec.is_supplementary))
    assert want > 0
    assert recorder.STAGE_COUNTS["extract_records"] == want


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _pool_run(dataset, name, level, *extra):
    """(output bytes, worker tables, parent log lines, worker log path,
    wall-clock interval) of one `genotype` run with the `trgt` logger at
    `level`; the workers' stderr goes to a file."""
    td, fasta, bed, bam = dataset
    prefix = os.path.join(td, name)
    log = logging.getLogger("trgt")
    saved_level = log.level
    handler = _Lines()
    log.addHandler(handler)
    log.setLevel(level)
    err_path = os.path.join(td, name + ".stderr")
    err_fd = os.dup(2)
    recorder.clear()
    t0 = time.time()
    try:
        with open(err_path, "wb") as fh:
            os.dup2(fh.fileno(), 2)
        rc = port_main(["genotype", "--genome", fasta, "--repeats", bed,
                        "--reads", bam, "--output-prefix", prefix,
                        "--device", "cpu", *extra])
    finally:
        os.dup2(err_fd, 2)
        os.close(err_fd)
        log.setLevel(saved_level)
        log.removeHandler(handler)
    t1 = time.time()
    assert rc == 0
    outputs = {ext: open(prefix + ext, "rb").read() for ext in OUTPUTS}
    tables = dict(recorder.WORKER_TABLES)
    recorder.clear()
    return outputs, tables, handler.lines, err_path, (t0, t1)


@pytest.fixture(scope="module")
def pool_runs(dataset):
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    mp.setattr(port_runner, "POOL_MIN_LOCI", 0)
    try:
        yield {"t1": _pool_run(dataset, "t1", logging.WARNING),
               "debug": _pool_run(dataset, "t2_debug", logging.DEBUG,
                                  "-t", "2"),
               "warning": _pool_run(dataset, "t2_warning", logging.WARNING,
                                    "-t", "2")}
    finally:
        mp.undo()


@pytest.mark.parametrize("run", ["debug", "warning"])
def test_pool_writes_the_t1_bytes(pool_runs, run):
    for ext in OUTPUTS:
        assert pool_runs[run][0][ext] == pool_runs["t1"][0][ext], ext


def test_pool_at_debug_sends_each_worker_span_table(pool_runs):
    """Every worker's table arrives, stamped inside the run; a worker that
    took loci recorded every span of the path, and its main thread's
    top-level spans never overlap."""
    _, tables, _, err_path, (t0, t1) = pool_runs["debug"]
    loci = {w: v["loci"] for w, v in trace.worker_lines(err_path).items()}
    assert sorted(tables) == [0, 1] and sum(loci.values()) == N_LOCI
    for w, table in tables.items():
        rows = table["rows"]
        assert table["dropped"] == table["dropped_nested"] == 0 and rows
        assert {r[0] for r in rows} == {-1}          # no card
        assert all(t0 < r[3] <= r[4] < t1 for r in rows)
        names = {r[2] for r in rows}
        assert "grant_wait" in names
        if loci[w]:
            assert MAIN_SPANS | EXTRACT_SPANS <= names
        main = [r for r in rows if r[6] == "MainThread" and r[5] is None]
        assert {r[2] for r in main} <= MAIN_SPANS
        main = sorted((r[3], r[4]) for r in main)
        assert all(a[1] <= b[0] for a, b in zip(main, main[1:]))


def test_pool_below_debug_sends_no_table(pool_runs):
    assert pool_runs["warning"][1] == {}


def test_done_line_parses_with_the_new_keys(pool_runs):
    _, _, _, err_path, _ = pool_runs["debug"]
    workers = trace.worker_lines(err_path)
    assert sorted(workers) == [0, 1]
    assert sum(w["loci"] for w in workers.values()) == N_LOCI
    for w in workers.values():
        assert w["counts"]["timeline_dropped"] == 0
        assert w["counts"]["timeline_dropped_nested"] == 0
        assert isinstance(w["kernels"], dict) and w["cuda_memory"] == {}
        if not w["loci"]:
            continue
        stages = w["stages"]
        assert MAIN_SPANS | EXTRACT_SPANS <= set(stages)
        # the done line rounds each to 1 ms
        assert stages["extract.inflate"] + stages["extract.decode"] + \
            stages["extract.build"] <= stages["extract"] + 0.002
        assert w["counts"]["extract_records"] > 0


def test_pool_line_reports_merge_write(pool_runs):
    lines = [m for m in pool_runs["debug"][2]
             if m.startswith("worker pool:")]
    assert len(lines) == 1 and "merge.write" in lines[0]
    assert float(lines[0].rsplit("merge.write ", 1)[1].split()[0]) >= 0


# ---- the benchmark's readers ----

@pytest.mark.parametrize("name", NEW_READERS)
def test_new_reader_reads_none_without_its_data(name):
    """A `--trace 0` run, or a program without the span: no worker
    reports it, no table reached the parent, no device trace."""
    recorder.clear()
    run = harness.Run({0: {"loci": 8, "stages": {"extract": 0.5},
                           "counts": {}, "kernels": {}}}, None)
    reader = importlib.import_module(f"gpubench.metrics.{name}")
    assert reader.read(run) is None


@pytest.mark.parametrize("name", ["merge_write_ms_per_locus",
                                  "idle_extract_wait_share"])
def test_parent_reader_reads_none_without_the_recorder(name, monkeypatch):
    from trgt_tpu_torch import utils
    monkeypatch.delattr(utils, "recorder")
    monkeypatch.setitem(sys.modules, "trgt_tpu_torch.utils.recorder", None)
    reader = importlib.import_module(f"gpubench.metrics.{name}")
    run = harness.Run({0: {"loci": 8}}, None)
    assert reader.read(run) is None


def _write_trace(path, worker, card, events):
    np.savez(path / f"worker{worker}.npz",
             names=np.array(["k"], dtype=str),
             name=np.zeros(len(events), dtype=np.int32),
             start=np.array([s for s, _ in events], dtype=float),
             dur=np.array([e - s for s, e in events], dtype=float),
             card=card, max_reserved=0, max_allocated=0)


def _row(card, sid, name, start, end, parent=None, thread="MainThread"):
    return [card, sid, name, start, end, parent, thread]


# (device events of each traced worker by card, each worker's spans,
#  expected extract_wait share, expected device_idle_share)
LAYOUTS = {
    "two workers on one card": (
        {0: (0, [(101, 102), (105, 106)]),
         1: (0, [(101.5, 103), (109, 111)])},
        {0: [_row(0, 1, "extract_wait", 100, 104),
             _row(0, 2, "genotype", 104, 107),
             _row(0, 3, "render", 107, 108)],
         1: [_row(0, 1, "grant_wait", 99, 100.5),
             _row(0, 2, "extract_wait", 102, 106.5),
             _row(0, 3, "extract.decode", 102, 106, parent=2),
             _row(0, 4, "extract", 100, 110, thread="ThreadPool_0")]},
        # worker 0: 2 of idle [100,101] [103,105] [106,109]; worker 1: 2.5
        100 * 4.5 / 20, 60.0),
    "one worker on each of two cards": (
        {0: (0, [(100, 105)]), 1: (1, [(90, 95)])},
        {0: [_row(0, 1, "extract_wait", 104, 107)],
         1: [_row(1, 1, "extract_wait", 100, 101)]},
        100 * (2 / 10 + 1 / 10) / 2, 75.0),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_idle_split_adds_up_to_device_idle_share(tmp_path, layout,
                                                 monkeypatch):
    device, rows, want_wait, want_idle = LAYOUTS[layout]
    for w, (card, events) in device.items():
        _write_trace(tmp_path, w, card, events)
    dev = trace.DeviceTrace(str(tmp_path), 100.0, 110.0)
    tables = {w: {"dropped": 0, "dropped_nested": 0, "rows": r}
              for w, r in rows.items()}
    run = harness.Run({}, dev)
    assert device_idle_share.read(run) == pytest.approx(want_idle)
    split = idle_split(dev, tables)
    assert sum(split.values()) == pytest.approx(want_idle)
    assert split["extract_wait"] == pytest.approx(want_wait)
    assert split[NO_SPAN] >= 0 and "extract" not in split
    assert "extract.decode" not in split
    monkeypatch.setattr(recorder, "WORKER_TABLES", tables)
    from gpubench.metrics import idle_extract_wait_share
    assert idle_extract_wait_share.read(run) == pytest.approx(want_wait)


def test_idle_split_reads_none_where_a_table_dropped_spans(tmp_path,
                                                          monkeypatch):
    """A worker whose timeline filled has no state for the end of the
    window: the split and the share read None, not a smaller share. A
    full store of nested spans alone does not matter."""
    device, rows, want_wait, _ = LAYOUTS["two workers on one card"]
    for w, (card, events) in device.items():
        _write_trace(tmp_path, w, card, events)
    dev = trace.DeviceTrace(str(tmp_path), 100.0, 110.0)
    tables = {w: {"dropped": 0, "dropped_nested": 7, "rows": r}
              for w, r in rows.items()}
    monkeypatch.setattr(recorder, "WORKER_TABLES", tables)
    from gpubench.metrics import idle_extract_wait_share
    run = harness.Run({}, dev)
    assert idle_extract_wait_share.read(run) == pytest.approx(want_wait)
    tables[1]["dropped"] = 1
    assert idle_split(dev, tables) is None
    assert idle_extract_wait_share.read(run) is None
