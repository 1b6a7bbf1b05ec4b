"""The port's block-addressed extract walk (reads/native_extract.py
`BlockReader`, csrc/bamcodec.cpp `trgt_reader_extract`) against the
port's Python twin (engine/workflow.py extract_reads + clip_reads) and
against `trgt_tpu`'s native extract, which inflates each BAI chunk
whole: the same reads in the same order, with the same bases, quals,
CIGAR, meth and mismatch offsets. Its counters are held against a model
of the walk over the file's own blocks: the blocks each walk reads bytes
of, through a least-recently-used cache of inflated bytes."""

import bisect
import gzip
import json
import os
import random
import struct
import sys
import threading
from collections import OrderedDict

import pytest

from gpubench import harness, synth
from gpubench.metrics import (extract_block_hit_share,
                              extract_inflated_mib_per_locus)
from trgt_tpu_torch.engine.workflow import Params, clip_reads, extract_reads
from trgt_tpu_torch.io.bam import BamReader
from trgt_tpu_torch.io.bam_write import BamWriter
from trgt_tpu_torch.reads import native_extract
from trgt_tpu_torch.utils import GenomicRegion, recorder
from trgt_tpu_torch.utils.synth import mm_ml_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2147601001
FLANK = 250
COUNTERS = ("extract_blocks_inflated", "extract_blocks_cached",
            "extract_inflated_bytes")


class Locus:
    def __init__(self, lid, contig, start, end):
        self.id = lid
        self.region = GenomicRegion(contig, start, end)


def port_params(min_rq=0.98, max_depth=250):
    return Params(min_flank_id_frac=0.7, min_read_qual=min_rq,
                  search_flank_len=FLANK, max_depth=max_depth)


def plain(read):
    return (read.id, read.is_reverse, read.bases, read.quals, read.meth,
            read.read_qual, read.mismatch_offsets, read.start_offset,
            read.end_offset, read.hp_tag, read.mapq,
            None if read.cigar is None
            else (read.cigar.ref_pos, list(read.cigar.ops)))


# ---- the datasets ----

def wgs_dataset(out_dir):
    """`gpubench/synth.py`'s wgs-hifi30x genome cut to 64 loci: 15-20 kb
    reads at 30x, one contig. Its BAM and its loci."""
    with open(os.path.join(ROOT, "gpubench", "configs",
                           "wgs-hifi30x.json")) as fh:
        cfg = dict(json.load(fh), catalog_loci=64)
    with open(os.path.join(ROOT, "gpubench", "mixes",
                           "genomewide-t4.json")) as fh:
        mix = json.load(fh)
    ds = synth.Dataset(cfg, mix, SEED)
    paths = ds.write(str(out_dir), len(ds.loci))
    loci = [Locus(lc.id, synth.CONTIG, lc.ref_start, lc.ref_end)
            for lc in ds.loci]
    return paths["reads"], loci


def hand_dataset(out_dir):
    """Two contigs of reads written by the port's BamWriter: MM/ML on
    both strands, soft clips, X, I and D ops, HP tags, secondary and
    unmapped-flagged records, rq on both sides of 0.97, and a 90 kb read
    whose record crosses three BGZF blocks. Loci on both contigs."""
    rng = random.Random(SEED)
    refs = [("chrA", 400_000), ("chrB", 200_000)]
    header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in refs)
    recs = []
    for tid, (_, length) in enumerate(refs):
        for i in range(length // 4000):
            recs.append((tid, rng.randrange(0, length - 25_000),
                         rng.randrange(5_000, 20_000), f"r{tid}_{i}"))
    recs.append((0, 150_000, 90_000, "long"))
    recs.sort()
    path = os.path.join(str(out_dir), "hand.bam")
    w = BamWriter(path, header, refs, build_index=True)
    for tid, pos, qlen, name in recs:
        cigar = [(rng.randrange(0, 200), "S")]
        left = qlen
        while left > 0:
            n = min(left, rng.randrange(500, 4000))
            cigar.append((n, "="))
            left -= n
            op = rng.choice("XID")
            cigar.append((rng.randrange(1, 4), op))
            if op != "D":
                left -= cigar[-1][0]
        cigar.append((rng.randrange(0, 200), "S"))
        cigar = [(n, op) for n, op in cigar if n > 0]
        seq = "".join(rng.choice("ACGT") for _ in range(
            sum(n for n, op in cigar if op in "MIS=X")))
        flag = rng.choice([0, 0, 16, 16, 0x100, 0x4])
        aux = [("rq", "f", rng.choice([0.999, 0.99, 0.96]))]
        if rng.random() < 0.5:
            aux.append(("HP", "i", rng.randrange(1, 3)))
        aux += mm_ml_for(seq, rng.randrange(0, 256)) or []
        w.write_record(name, flag, tid, pos, 60, cigar, seq,
                       bytes(rng.randrange(2, 60) for _ in seq), aux)
    w.close()
    loci = [Locus(f"A{i}", "chrA", p, p + 60)
            for i, p in enumerate(range(2_000, 400_000, 9_000))]
    loci += [Locus("Along", "chrA", 200_000, 200_090)]
    loci += [Locus(f"B{i}", "chrB", p, p + 40)
             for i, p in enumerate(range(1_000, 200_000, 11_000))]
    return path, loci


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    if native_extract._get_lib() is None:
        pytest.skip("the port's native codec did not build")
    out = tmp_path_factory.mktemp("torch_native_extract")
    return {"wgs": wgs_dataset(out), "hand": hand_dataset(out)}


# ---- the model of the walk ----

class BamFile:
    """The BAM's blocks and its inflated stream, read independently of
    both walks: the BC subfield of each block and gzip's inflate."""

    def __init__(self, path):
        with open(path, "rb") as fh:
            raw = fh.read()
        self.coffsets, self.sizes, self.ustarts = [], [], []
        pos = ustart = 0
        while pos < len(raw):
            xlen, = struct.unpack_from("<H", raw, pos + 10)
            extra = raw[pos + 12:pos + 12 + xlen]
            k = extra.index(b"BC\x02\x00")
            bsize = struct.unpack_from("<H", extra, k + 4)[0] + 1
            isize, = struct.unpack_from("<I", raw, pos + bsize - 4)
            self.coffsets.append(pos)
            self.sizes.append(isize)
            self.ustarts.append(ustart)
            ustart += isize
            pos += bsize
        self.data = gzip.decompress(raw)
        self.start_of = dict(zip(self.coffsets, self.ustarts))
        self.size_of = dict(zip(self.coffsets, self.sizes))
        assert len(self.data) == ustart

    def absolute(self, voffset):
        return self.start_of[voffset >> 16] + (voffset & 0xFFFF)

    def blocks(self, a, b):
        """Offsets of the non-empty blocks that hold bytes [a, b)."""
        i = bisect.bisect_right(self.ustarts, a) - 1
        out = []
        while i < len(self.ustarts) and self.ustarts[i] < b:
            if self.sizes[i]:
                out.append(self.coffsets[i])
            i += 1
        return out

    def walk(self, chunks, tid, end):
        """(blocks the walk reads bytes of, in order, each once; the most
        blocks one record it read spans): from each chunk's begin to its
        end, a record at another tid or at or past `end` read as far as
        its block_size, refID and pos, and the walk over there."""
        touched, widest = [], 0

        def touch(a, b):
            for c in self.blocks(a, b):
                if not touched or touched[-1] != c:
                    touched.append(c)

        for vbeg, vend in chunks:
            p, stop = self.absolute(vbeg), self.absolute(vend)
            while p < stop:
                size, ref_id, pos = struct.unpack_from("<iii", self.data, p)
                if ref_id != tid or pos >= end:
                    touch(p, p + 12)
                    return touched, widest
                touch(p, p + 4 + size)
                widest = max(widest, len(self.blocks(p, p + 4 + size)))
                p += 4 + size
        return touched, widest


class LruModel:
    """A least-recently-used cache of inflated bytes, as the reader's:
    a missed block goes in, then the oldest go while more than `capacity`
    bytes are held, never the newest."""

    def __init__(self, capacity):
        self.capacity = capacity
        self.held = 0
        self.cache = OrderedDict()

    def visit(self, blocks, size_of):
        """(missed, served, inflated bytes) of one walk."""
        missed = served = inflated = 0
        for c in blocks:
            if c in self.cache:
                self.cache.move_to_end(c)
                served += 1
                continue
            missed += 1
            inflated += size_of[c]
            self.cache[c] = size_of[c]
            self.held += size_of[c]
            while self.held > self.capacity and len(self.cache) > 1:
                self.held -= self.cache.popitem(last=False)[1]
        return missed, served, inflated


# ---- the cases ----

def interleaved(loci, workers=4, grant=2):
    """(reader, locus) visits of a -t 4 pool: 2-locus grants in turn."""
    return [((g // grant) % workers, lc)
            for g, lc in enumerate(loci)]


def case_interleaved(data):
    bam, loci = data["wgs"]
    return bam, interleaved(loci), port_params()


def case_reverse(data):
    bam, loci = data["wgs"]
    return bam, [(0, lc) for lc in reversed(loci)], port_params()


def case_twice(data):
    bam, loci = data["wgs"]
    return bam, [(0, lc) for lc in loci for _ in range(2)], port_params()


def case_evicting(data):
    bam, loci = data["wgs"]
    # three blocks' room: the walks of neighbouring loci evict each other
    return (bam, [(0, lc) for lc in loci], port_params(),
            3 * synth.bamio.BGZF_BLOCK)


def case_reservoir(data):
    bam, loci = data["wgs"]
    # max-depth 6: 18 kept of the 25-40 reads passing at a locus
    return bam, [(0, lc) for lc in loci[:24]], port_params(max_depth=6)


def case_several_bins(data):
    bam, loci = data["wgs"]
    index = BamReader(bam)._load_index()
    several = [lc for lc in loci if len(index.chunks_for(
        0, max(0, lc.region.start - FLANK), lc.region.end + FLANK)) > 1]
    return bam, [(0, lc) for lc in several], port_params()


def case_beyond_linear_index(data):
    bam, loci = data["wgs"]
    index = BamReader(bam)._load_index()
    n_intv = len(index.refs[0][1])
    past = Locus("past", synth.CONTIG, (n_intv << 14) + 500,
                 (n_intv << 14) + 560)
    return bam, [(0, loci[-1]), (0, past)], port_params()


def case_last_block(data):
    bam, loci = data["wgs"]
    last = max(loci, key=lambda lc: lc.region.end)
    return bam, [(0, last)], port_params()


def case_two_contigs(data):
    bam, loci = data["hand"]
    return bam, [(0, lc) for lc in loci], port_params(min_rq=0.97)


def case_two_contigs_reversed(data):
    bam, loci = data["hand"]
    return bam, [(0, lc) for lc in reversed(loci)], port_params(min_rq=-1.0)


CASES = {f.__name__[5:]: f for f in (
    case_interleaved, case_reverse, case_twice, case_evicting,
    case_reservoir, case_several_bins, case_beyond_linear_index,
    case_last_block, case_two_contigs, case_two_contigs_reversed)}


def tpu_twin(bam_path, locus, p):
    """`trgt_tpu`'s native extract of the locus: each chunk inflated
    whole, the records walked from its begin."""
    from trgt_tpu.engine.workflow import Params as TpuParams
    from trgt_tpu.io.bam import BamReader as TpuBamReader
    from trgt_tpu.reads.native_extract import extract_and_clip_native
    from trgt_tpu.utils import GenomicRegion as TpuRegion
    tp = TpuParams(min_flank_id_frac=p.min_flank_id_frac,
                   min_read_qual=p.min_read_qual,
                   search_flank_len=p.search_flank_len,
                   max_depth=p.max_depth)
    r = locus.region
    tl = Locus(locus.id, r.contig, r.start, r.end)
    tl.region = TpuRegion(r.contig, r.start, r.end)
    reads = extract_and_clip_native(tl, TpuBamReader(bam_path), tp,
                                    2 * p.search_flank_len)
    assert reads is not None
    return reads


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_walk_matches_the_twins_and_the_model(case, data):
    """Every visit: the block walk's reads == the Python twin's ==
    `trgt_tpu`'s native extract's, and its counters == the model's:
    blocks inflated + blocks cached == the distinct blocks the walk
    touched, inflated bytes == the sizes of the blocks the cache missed."""
    bam_path, visits, p, *cache = CASES[case](data)
    cache_bytes = cache[0] if cache else native_extract.BLOCK_CACHE_BYTES
    model_file = BamFile(bam_path)
    python_bam = BamReader(bam_path)
    readers, models = {}, {}
    seen = []
    for worker, locus in visits:
        if worker not in readers:
            readers[worker] = BamReader(bam_path)
            readers[worker].block_reader = native_extract.BlockReader(
                bam_path, cache_bytes)
            models[worker] = LruModel(cache_bytes)
        bam = readers[worker]
        before = {k: recorder.STAGE_COUNTS[k] for k in COUNTERS}
        got = native_extract.extract_and_clip_native(locus, bam, p,
                                                     2 * FLANK)
        counts = [recorder.STAGE_COUNTS[k] - before[k] for k in COUNTERS]
        assert got is not None
        want = clip_reads(locus, 2 * FLANK,
                          extract_reads(locus, python_bam, p))
        assert [plain(r) for r in got] == [plain(r) for r in want], locus.id
        assert [plain(r) for r in got] == \
            [plain(r) for r in tpu_twin(bam_path, locus, p)], locus.id
        r = locus.region
        beg, end = max(0, r.start - FLANK), r.end + FLANK
        tid = bam.header.tid(r.contig)
        index = bam._load_index()
        chunks = index.chunks_for(tid, beg, end)
        # each walk begins at or past the linear index's floor
        ioffsets = index.refs[tid][1]
        if beg >> 14 < len(ioffsets):
            assert all(c0 >= ioffsets[beg >> 14] for c0, _ in chunks)
        touched, widest = model_file.walk(chunks, tid, end)
        assert sum(counts[:2]) == len(touched), locus.id
        assert tuple(counts) == models[worker].visit(
            touched, model_file.size_of), locus.id
        seen.append(Visit(locus, got, chunks, touched, widest, counts))
    for bam in readers.values():
        bam.close()
    CHECKS[case](seen, model_file, p)


class Visit:
    def __init__(self, locus, reads, chunks, touched, widest, counts):
        self.locus, self.reads, self.chunks = locus, reads, chunks
        self.touched, self.widest = touched, widest
        self.inflated, self.cached, self.inflated_bytes = counts


def check_interleaved(seen, model_file, p):
    assert sum(len(v.reads) for v in seen) > 20 * len(seen)


def check_several_bins(seen, model_file, p):
    assert len(seen) >= 4 and all(len(v.chunks) > 1 for v in seen)


def check_reverse(seen, model_file, p):
    assert sum(1 for v in seen if v.reads) > 0.9 * len(seen)


def check_twice(seen, model_file, p):
    for first, second in zip(seen[::2], seen[1::2]):
        assert first.touched == second.touched
        assert second.inflated == second.inflated_bytes == 0
        assert second.cached == len(second.touched) > 0


def check_evicting(seen, model_file, p):
    distinct = {c for v in seen for c in v.touched}
    assert sum(v.inflated for v in seen) > len(distinct)


def check_reservoir(seen, model_file, p):
    assert any(len(v.reads) == 3 * p.max_depth for v in seen)


def check_beyond_linear_index(seen, model_file, p):
    past = seen[-1]
    assert past.chunks and past.touched and past.reads == []


def check_last_block(seen, model_file, p):
    last = max(c for c, size in model_file.size_of.items() if size)
    assert seen[0].reads and seen[0].touched[-1] == last


def check_two_contigs(seen, model_file, p):
    assert {v.locus.region.contig for v in seen if v.reads} == \
        {"chrA", "chrB"}
    assert max(v.widest for v in seen) >= 3
    assert any(r.meth for v in seen for r in v.reads)
    assert any(r.mismatch_offsets for v in seen for r in v.reads)
    assert any(r.is_reverse for v in seen for r in v.reads)


CHECKS = {"interleaved": check_interleaved, "reverse": check_reverse,
          "twice": check_twice, "evicting": check_evicting,
          "reservoir": check_reservoir, "several_bins": check_several_bins,
          "beyond_linear_index": check_beyond_linear_index,
          "last_block": check_last_block,
          "two_contigs": check_two_contigs,
          "two_contigs_reversed": check_two_contigs}


# ---- the benchmark's readers of the counters ----

def test_block_readers_read_the_workers_counters():
    run = harness.Run({
        0: {"loci": 30, "counts": {"extract_inflated_bytes": 3 << 20,
                                   "extract_blocks_inflated": 50,
                                   "extract_blocks_cached": 150}},
        1: {"loci": 10, "counts": {"extract_inflated_bytes": 1 << 20,
                                   "extract_blocks_inflated": 25,
                                   "extract_blocks_cached": 25}},
        2: {"loci": 0, "counts": {}}}, None)
    assert extract_inflated_mib_per_locus.read(run) == pytest.approx(0.1)
    assert extract_block_hit_share.read(run) == pytest.approx(70.0)
    idle = harness.Run({0: {"loci": 4, "counts": {
        "extract_blocks_inflated": 0, "extract_blocks_cached": 0}}}, None)
    assert extract_block_hit_share.read(idle) is None


def test_one_reader_under_many_threads(data):
    """More threads than cores, switching often, all on one reader: each
    locus's reads are those of a walk alone, and every walk counted each
    block it touched once."""
    bam_path, loci = data["wgs"]
    p = port_params()
    alone = {}
    for lc in loci:
        bam = BamReader(bam_path)
        reads = native_extract.extract_and_clip_native(lc, bam, p, 2 * FLANK)
        alone[lc.id] = [plain(r) for r in reads]
        bam.close()
    shared = BamReader(bam_path)
    shared._load_index()
    got, errors = {}, []
    before = {k: recorder.STAGE_COUNTS[k] for k in COUNTERS}

    def work(k):
        try:
            for lc in loci[k::4] + loci[::-1][k::5]:
                reads = native_extract.extract_and_clip_native(
                    lc, shared, p, 2 * FLANK)
                got.setdefault(lc.id, []).append([plain(r) for r in reads])
        except Exception as e:   # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k % 4,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(got) == sorted(alone)
    for lid, runs in got.items():
        assert all(r == alone[lid] for r in runs), lid
    model_file = BamFile(bam_path)
    index = shared._load_index()
    touched = 0
    for lc in loci:
        r = lc.region
        chunks = index.chunks_for(0, max(0, r.start - FLANK), r.end + FLANK)
        touched += len(got[lc.id]) * len(
            model_file.walk(chunks, 0, r.end + FLANK)[0])
    counts = [recorder.STAGE_COUNTS[k] - before[k] for k in COUNTERS]
    assert counts[0] + counts[1] == touched
    shared.close()
