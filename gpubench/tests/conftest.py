"""Helpers of the benchmark's CPU tests: a manifest of one tiny cell in a
scratch root, run by the harness in this process on the host twins."""

import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MIX = {"name": "tiny", "threads": 2, "block": 64,
            "strata": [[40, 10, 60], [24, 60, 200]],
            "motifs": ["T", "TG", "CAG", "GATA", "AATGG"], "decoy_every": 7,
            "compound_every": 7,
            "max_loci_per_s": 400, "check_share": 0.5}


def make_root(path, config="targeted-panel", mix=None, traffic="tiny"):
    """A scratch root holding BENCHMARK.json with the one cell
    `x.<traffic>`, the configuration cut to 64 loci and the mix."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    os.makedirs(path / "gpubench" / "configs", exist_ok=True)
    os.makedirs(path / "gpubench" / "mixes", exist_ok=True)
    with open(os.path.join(ROOT, "gpubench", "configs", config + ".json")) as fh:
        cfg = json.load(fh)
    cfg["catalog_loci"] = 64
    (path / "gpubench" / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    (path / "gpubench" / "mixes" / f"{traffic}.json").write_text(
        json.dumps(mix or TINY_MIX))
    cell = f"x.{traffic}"
    bench["configs"] = [{"name": config, "source": "CPU test",
                         "file": f"gpubench/configs/{config}.json",
                         "reduced": ["catalog_loci"], "why": "CPU test"}]
    bench["workloads"] = [{"name": cell, "config": config, "traffic": traffic,
                           "chips": 1, "why": "CPU test"}]
    for m in bench["per_layer"]:
        m["workloads"] = [cell]
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def run_cell(root, cell, seed=3000000123, seconds=3, trace=0):
    """(exit code, result dict or None, stdout) of one harness run."""
    from gpubench import harness
    return harness.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        time.perf_counter(), device="host", root=str(root))


@pytest.fixture
def tiny_root(tmp_path):
    return tmp_path, make_root(tmp_path)
