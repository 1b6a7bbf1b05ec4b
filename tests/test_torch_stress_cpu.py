"""The port's --device cpu (its kernels' plain versions, float32 Viterbi)
against the float32 anchors that chip_smoke.py pins: trgt_tpu --device
cpu's records of the noisy catalogs, and trgt_tpu --device host's of the
adversarial catalog, on which trgt_tpu's two paths agree
(tests/test_adversarial_e2e.py). bench96 is left to the card: the plain
Viterbi walks its 10 kb alleles in Python.

A module of its own, beside test_torch_stress.py, so that these runs (the
plain flank version walks every read of the noisy catalog) go to another
test worker than trgt_tpu's."""

import pytest

from test_torch_stress import cs, run, threads  # noqa: F401

CPU_RUNS = [key for key in cs.RUN_MD5 if key[0] == "adversarial"
            or key[0].startswith("noisy") and key[2] == "cpu"]


@pytest.mark.parametrize("key", CPU_RUNS, ids="-".join)
def test_port_cpu_makes_anchor_records(run, key):
    assert cs.records_md5(run("port", key[0], key[1], "cpu")) == \
        cs.RUN_MD5[key]
