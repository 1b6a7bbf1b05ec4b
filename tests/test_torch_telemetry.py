"""The port's kernel counters (kernels/telemetry.py): locked, so that
threads adding at once lose no count; and what a `--device cpu` run
counts equals the module's formulas applied to the calls that run made
to the kernels' dispatch functions."""

import sys
import threading

import pytest
import torch

from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.kernels import e2e, editdist, telemetry
from trgt_tpu_torch.kernels import semiglobal as sg
from trgt_tpu_torch.kernels import viterbi as vt
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset

torch.set_num_threads(1)


def test_concurrent_adds_lose_no_count():
    n_threads, n_adds = 16, 2000
    telemetry.clear()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_adds):
                telemetry.add("stress", launches=1, cells=3)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert telemetry.snapshot()["stress"] == {
        "launches": n_threads * n_adds, "cells": 3 * n_threads * n_adds}
    telemetry.clear()
    assert telemetry.snapshot() == {}


def test_totals_and_bound():
    snap = {"e2e_full": {"launches": 2, "cells": 10, "bytes_in": 5},
            "e2e_band": {"launches": 3, "cells": 20, "bytes_out": 7},
            "flank": {"launches": 1}}
    assert telemetry.totals(snap) == {
        "flank": {"launches": 1},
        "e2e": {"launches": 5, "cells": 30, "bytes_in": 5, "bytes_out": 7}}
    ms, by = telemetry.bound_ms("e2e", {"cells": 1e9, "bytes_in": 1})
    assert by == "operations"
    assert ms == pytest.approx(14e9 / 67e12 * 1e3)
    ms, by = telemetry.bound_ms("flank", {"cells": 1, "bytes_in": 3.35e9})
    assert (by, ms) == ("bytes", pytest.approx(1.0))
    assert telemetry.pct_peak("editdist", 67e12 / 5) == pytest.approx(100)


class Calls:
    """Records the arguments and outputs of `module.name` while active."""

    def __init__(self, monkeypatch, module, name):
        self.calls = []
        orig = getattr(module, name)

        def wrapped(*args):
            out = orig(*args)
            self.calls.append((args, out))
            return out

        monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def targeted_dataset(tmp_path_factory):
    """Reads with 2 % errors: spans miss the exact path, the cluster
    genotyper finds pairs to measure, the 180 bp allele takes the band
    class of e2e and the short ones its full-matrix class."""
    td = str(tmp_path_factory.mktemp("torch_telemetry"))
    loci = [SynthLocus("HET", "CAG", 10, (10, 20)),
            SynthLocus("EXP", "GGC", 8, (8, 60)),
            SynthLocus("MIX", "CAG", 12, (12, 16), motifs="CAG,CAA")]
    return make_dataset(td, loci, depth=12, error_rate=0.02, seed=11)


def test_cpu_run_counts_equal_the_formulas(targeted_dataset, monkeypatch,
                                           tmp_path):
    cap = {"flank": Calls(monkeypatch, sg, "flank_align"),
           "viterbi": Calls(monkeypatch, vt, "viterbi_segs"),
           "viterbi_batches": Calls(monkeypatch, vt, "prepare_batch"),
           "editdist": Calls(monkeypatch, editdist, "edit_distances"),
           "e2e_full": Calls(monkeypatch, e2e, "e2e_scan"),
           "e2e_band": Calls(monkeypatch, e2e, "e2e_banded")}
    fasta, bed, bam = targeted_dataset
    telemetry.clear()
    assert port_main(["genotype", "--genome", fasta, "--repeats", bed,
                      "--reads", bam, "--output-prefix",
                      str(tmp_path / "out"), "--preset", "targeted",
                      "--device", "cpu"]) == 0
    got = telemetry.snapshot()
    nb = telemetry.nbytes
    want = {
        "flank": [dict(cells=telemetry.flank_cells(a[0], a[2]),
                       bytes_in=nb(*a[:3]), bytes_out=nb(out))
                  for a, out in cap["flank"].calls],
        "viterbi": [dict(cells=telemetry.viterbi_cells(b[0], b[1]),
                         bytes_in=nb(*a[:4]), bytes_out=nb(out))
                    for (a, out), (b, _) in zip(
                        cap["viterbi"].calls, cap["viterbi_batches"].calls)],
        "editdist": [dict(cells=telemetry.editdist_cells(a[2], a[3]),
                          bytes_in=nb(*a), bytes_out=nb(out))
                     for a, out in cap["editdist"].calls],
        "e2e_full": [dict(cells=telemetry.e2e_cells(a[2], a[3]),
                          bytes_in=telemetry.e2e_bytes_in(a[2], a[3]),
                          bytes_out=telemetry.e2e_bytes_out(out[3]))
                     for a, out in cap["e2e_full"].calls],
        "e2e_band": [dict(cells=telemetry.e2e_cells(a[2], a[3], a[4]),
                          bytes_in=telemetry.e2e_bytes_in(a[2], a[3]),
                          bytes_out=telemetry.e2e_bytes_out(out[3]))
                     for a, out in cap["e2e_band"].calls],
    }
    assert len(cap["viterbi"].calls) == len(cap["viterbi_batches"].calls)
    for kernel, per_call in want.items():
        assert per_call, f"the run made no {kernel} call"
        sums = {"calls": len(per_call)}
        for call in per_call:
            for k, v in call.items():
                sums[k] = sums.get(k, 0) + v
        # the plain versions ran: nothing was launched
        assert got[kernel] == sums, kernel
    assert telemetry.totals(got)["e2e"]["calls"] == \
        len(want["e2e_full"]) + len(want["e2e_band"])
