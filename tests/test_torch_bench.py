"""bench_torch.py, the port's bench, on the CPU: its result line, the
anchor and pin checks that decide `correct`, and its refusal to run
without a card unless `--device cpu` asks for the plain versions."""

import contextlib
import copy
import io
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench_torch  # noqa: E402  (beside chip_smoke.py, at the root)

torch.set_num_threads(1)

N_LOCI = 6


def bench_args(root, *extra):
    return ["--cell", "bench96-wgs", "--loci", str(N_LOCI), "--repeats",
            "1", "--data-root", str(root), *extra]


def json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """One `--device cpu` bench of the first 6 bench96 loci: (exit code,
    its JSON lines, each genotype run's numbers by name, the data root)."""
    root = tmp_path_factory.mktemp("bench") / "data"
    runs = {}
    run = bench_torch.Bench.run

    def recording(self, cell, dsdir, bed, reads, name, **kw):
        runs[name] = run(self, cell, dsdir, bed, reads, name, **kw)
        return copy.deepcopy(runs[name])

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(bench_torch.Bench, "run", recording)
        rc = bench_torch.main(bench_args(root, "--device", "cpu"))
    return rc, json_lines(out.getvalue()), runs, root


def test_result_line(bench_run):
    rc, lines, runs, _root = bench_run
    assert rc == 0
    assert all(line["platform"] == "cpu" for line in lines)
    assert [line["kind"] for line in lines] == ["run", "result", "result"]
    result = lines[-1]
    assert result["partial"] is False and result["cut_by_deadline"] is False
    assert result["cell"] == "bench96-wgs" and result["loci"] == N_LOCI
    assert result["correct"] is True
    assert result["correct_by"] == "truth and anchor"
    checks = result["checks"]
    assert checks["pins"] is None and checks["anchor"] is True
    assert checks["truth"]["checked"] > 0 and checks["truth"]["failed"] == 0
    assert result["failed_loci"] == {"failed": 0, "attempted": N_LOCI}
    lps = result["loci_per_s"]
    assert lps["n_runs"] == 1 and lps["p25"] == lps["median"] == lps["p75"]
    assert lps["median"] == pytest.approx(N_LOCI / result["wall_s"]["median"])
    assert result["setup_s"] > 0 and result["data_s"] > 0
    assert result["host_loci_per_s"] > 0
    assert result["vs_host"] == pytest.approx(
        lps["median"] / result["host_loci_per_s"])
    assert result["anchor"]["loci"] == N_LOCI
    assert {"extract", "spans", "genotype", "annotate", "write"} <= \
        set(result["stages"])
    for name in ("flank", "viterbi", "e2e"):
        k = result["kernels"][name]
        # counted from the plain versions' inputs; no launch off a card
        assert k["calls"] > 0 and k["cells"] > 0 and k["launches"] == 0
        assert k["bytes_in"] > 0 and k["bound_ms"] > 0
    assert result["e2e_routed"]
    # never a CPU number under a device field
    assert result["busy_share"] is None and result["memory_used_mib"] is None
    assert result["profile"] is None and result["card"] is None
    assert result["rss_mib"]["genotype process"] > 0
    # the warm call, the anchor and the timed run
    assert sorted(runs) == ["bench96-wgs_host", "bench96-wgs_run0",
                            "bench96-wgs_warm"]


def test_tampered_anchor_fails(bench_run, monkeypatch, capsys):
    """The same runs, read back with one anchor record changed: the exit
    is non-zero and the result says correct: false."""
    _rc, _lines, runs, root = bench_run
    monkeypatch.setattr(bench_torch.Bench, "run",
                        lambda self, cell, dsdir, bed, reads, name, **kw:
                        copy.deepcopy(runs[name]))
    records = bench_torch.cs.records
    anchor = runs["bench96-wgs_host"]["prefix"]

    def tampered(prefix):
        vcf, bam = records(prefix)
        if prefix == anchor:
            vcf = vcf[:-1] + ("0" if vcf[-1] != "0" else "1")
        return vcf, bam

    monkeypatch.setattr(bench_torch.cs, "records", tampered)
    assert bench_torch.main(bench_args(root, "--device", "cpu")) != 0
    result = json_lines(capsys.readouterr().out)[-1]
    assert result["kind"] == "result" and result["correct"] is False
    assert result["checks"]["anchor"] is False


def test_pin_check(bench_run):
    _rc, _lines, runs, _root = bench_run
    prefix = runs["bench96-wgs_run0"]["prefix"]
    right = bench_torch.cs.records_md5(prefix)
    assert bench_torch.pins_match(prefix, right)
    assert not bench_torch.pins_match(prefix, (right[0], "0" * 32))
    assert not bench_torch.pins_match(
        prefix, bench_torch.cs.RUN_MD5[("bench96", "wgs", "host")])


def test_no_card_no_rate(bench_run, monkeypatch, capsys):
    """Without a card and without --device cpu: a non-zero exit before
    any run, and no rate printed."""
    _rc, _lines, _runs, root = bench_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(bench_args(root)) != 0
    out = capsys.readouterr()
    assert "loci_per_s" not in out.out and out.out.strip() == ""
    assert "torch.cuda.is_available() is false" in out.err
