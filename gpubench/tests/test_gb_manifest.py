"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and that everything it names is found by name under gpubench/."""

import ast
import glob
import json
import os
import re

import pytest

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"]
    assert bench["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in bench["workloads"]] + \
            [c["why"] for c in bench["configs"]] + \
            [c["source"] for c in bench["configs"]] + \
            [m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert all(k in cfg for k in c["reduced"])
        assert set(cfg["limits"]) == {"span_reads_off", "genotype_off",
                                      "allele_bases_off", "annotation_off"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_entry_is_found_by_name(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "gpubench", "mixes",
                                           w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(ROOT, "gpubench", "metrics",
                                           m["name"] + ".py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(ROOT, "gpubench", "**", "*.py"),
                          recursive=True):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & {"jax", "jaxlib", "flax", "trgt_tpu"}, path
