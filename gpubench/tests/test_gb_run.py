"""Whole runs of a tiny cell on the host twins (the look for a card
skipped): the result line, a mix added as a file, and the correctness
check failing where the timed path is broken underneath or the control
takes the program's place."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from gpubench import control, harness, synth

from .conftest import ROOT, TINY_MIX, make_root, run_cell


def _result(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]) if out else None


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tiny_root, capsys, trace):
    root, cell = tiny_root
    assert run_cell(root, cell, trace=trace) == 0
    res = _result(capsys)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    with open(root / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench[kind]}
    assert set(res["metrics"]) <= names
    if trace:
        # host stages and counters are there; the device's are not
        assert {"worker_ready_s", "extract_ms_per_locus",
                "genotype_ms_per_locus"} <= set(res["metrics"])
        assert "device_idle_share" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"loci_per_s", "setup_s"}
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_mix_added_as_a_file_is_found(tmp_path, capsys):
    mix = dict(TINY_MIX, name="shorter", strata=[[64, 10, 30]])
    cell = make_root(tmp_path, config="wgs-hifi30x", mix=mix,
                     traffic="shorter")
    _, _, cfg, found = harness.load_cell(cell, str(tmp_path))
    assert found == mix and cfg["catalog_loci"] == 64
    assert run_cell(tmp_path, cell) == 0
    assert _result(capsys)["correct"] is True


def test_control_is_not_correct():
    for name in ("targeted-panel", "wgs-hifi30x"):
        with open(os.path.join(ROOT, "gpubench", "configs", name + ".json")) as fh:
            cfg = json.load(fh)
        cfg["catalog_loci"] = 64
        for seed in (1, 2, 3):
            numbers = control.control_numbers(cfg, TINY_MIX, seed)
            assert any(numbers[k] > v for k, v in cfg["limits"].items()), \
                (name, seed, numbers)


# faults planted in the workers through a sitecustomize module on their
# PYTHONPATH: the timed path broken underneath the harness
FAULTS = {
    "answer_altered": """
        from trgt_tpu_torch.io.vcf_write import VcfWriter
        _render = VcfWriter.render
        def render(locus, result):
            line = _render(locus, result)
            f = line.split("\\t")
            if f[4] not in (".", "") and len(f[4]) > 3:
                f[4] = f[4][:2] + f[4][3:]      # one base of an allele lost
            return "\\t".join(f)
        VcfWriter.render = staticmethod(render)
        """,
    "half_the_batch_left_out": """
        from trgt_tpu_torch.engine.pipeline import BatchPipeline
        _finish = BatchPipeline._finish_batch
        def finish(self, states):
            for k, item in enumerate(_finish(self, states)):
                if k % 2 == 0:
                    yield item
        BatchPipeline._finish_batch = finish
        """,
    "het_called_hom": """
        from trgt_tpu_torch.io.vcf_write import VcfWriter
        _render = VcfWriter.render
        def render(locus, result):
            line = _render(locus, result)
            f = line.split("\\t")
            if f[9].startswith("0/1:"):
                f[9] = "0/0:" + f[9][4:]    # a het locus called hom
            return "\\t".join(f)
        VcfWriter.render = staticmethod(render)
        """,
    "step_returns_its_state": """
        from trgt_tpu_torch.engine.pipeline import BatchPipeline
        BatchPipeline._stage_impure_filter = lambda self, states: None
        """,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_root, tmp_path, capsys,
                                            monkeypatch, fault):
    root, cell = tiny_root
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(textwrap.dedent(FAULTS[fault]))
    monkeypatch.setenv("PYTHONPATH", str(site))
    rc = run_cell(root, cell, seconds=4)
    res = _result(capsys)
    assert rc != 0 or res["correct"] is False, res


@pytest.mark.cuda
def test_cell_on_the_card(tmp_path):
    """One short run of the first cell on the card, by its command."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        cell = json.load(fh)["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
