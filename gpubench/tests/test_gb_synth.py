"""The generator repeats exactly by seed, and its layout keeps its
promises: every read either spans a locus with both flanks or misses it,
and every seed holds the same sizes."""

import hashlib
import json
import os

import numpy as np

from gpubench import harness, synth

from .conftest import ROOT, TINY_MIX


def _cfg(name):
    with open(os.path.join(ROOT, "gpubench", "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["catalog_loci"] = 64
    return cfg


def _digest(d):
    h = hashlib.sha256()
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def test_same_seed_same_files(tmp_path):
    digests = []
    for k, seed in enumerate((2**31 + 7, 2**31 + 7, 5)):
        d = tmp_path / str(k)
        d.mkdir()
        synth.Dataset(_cfg("wgs-hifi30x"), TINY_MIX, seed).write(str(d), 200)
        digests.append(_digest(d))
    assert digests[0] == digests[1] != digests[2]


def test_seeds_hold_the_same_sizes():
    def sizes(seed):
        ds = synth.Dataset(_cfg("targeted-panel"), TINY_MIX, seed)
        return sorted((tuple(len(a) for a in lc.alleles), lc.depth,
                       ",".join(lc.motifs)) for lc in ds.loci)
    assert sizes(1) == sizes(2**33 + 1)


def test_genome_reads_span_or_miss_each_locus():
    cfg = _cfg("wgs-hifi30x")
    ds = synth.Dataset(cfg, TINY_MIX, 11)
    guard = cfg["end_guard"]
    for i in range(len(ds.loci)):
        ts = np.where(ds.r_hap == 0, ds.hap_tr[0][i, 0], ds.hap_tr[1][i, 0])
        te = np.where(ds.r_hap == 0, ds.hap_tr[0][i, 1], ds.hap_tr[1][i, 1])
        span = (ds.r_start <= ts - guard) & (ds.r_end >= te + guard)
        miss = (ds.r_end <= ts - guard) | (ds.r_start >= te + guard)
        assert np.all(span | miss)
        assert span.sum() >= 1


def test_sample_holds_each_blocks_longest_locus():
    ds = synth.Dataset(_cfg("targeted-panel"), TINY_MIX, 3)
    ids = harness.sample_ids(ds, TINY_MIX, 3)
    longest = max(ds.loci, key=lambda lc: max(len(a) for a in lc.alleles))
    assert longest.id in ids and len(ids) < len(ds.loci)
