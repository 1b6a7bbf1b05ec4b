"""The port keeps its own copies of the JAX package's numpy/stdlib modules
(trgt_tpu_torch/{utils,io,reads,hmm,genotype,kernels,engine}). Each copy
is held against its original on seeded inputs: one parametrised test, one
case per group of modules, every comparison exact."""

import dataclasses
import importlib
import os
import random
import re

import numpy as np
import pytest

PACKAGES = ("trgt_tpu_torch", "trgt_tpu")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def plain(x):
    """Comparable form of a result: dataclasses, enums, numpy arrays and
    objects with __slots__ become tuples of builtins, so values of the
    two packages' own classes compare by content."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.shape, str(x.dtype), x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return tuple(sorted((plain(k), plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if hasattr(x, "__slots__") and not isinstance(x, (bytes, str)):
        return (type(x).__name__,
                tuple((s, plain(getattr(x, s))) for s in x.__slots__))
    if hasattr(x, "name") and hasattr(x, "value") and \
            type(x).__module__.endswith("enums"):
        return (type(x).__name__, x.name)
    return x


def random_dna(rng, lo, hi):
    return bytes(rng.choice(b"ACGT") for _ in range(rng.randint(lo, hi)))


def noisy_repeat(rng, motif, copies, rate):
    out = bytearray()
    for c in motif * copies:
        r = rng.random()
        if r < rate / 3:
            continue
        out.append(rng.choice(b"ACGT") if r < 2 * rate / 3 else c)
        if rng.random() < rate / 3:
            out.append(rng.choice(b"ACGT"))
    return bytes(out)


def case_hmm(pkg, tmp):
    """`build_hmm` arrays and `Hmm.label` paths (the state both packages'
    Viterbi tables are made from)."""
    hmm = mod(pkg, "hmm")
    rng = random.Random(5)
    out = []
    for motifs in ([b"CAG"], [b"A"], [b"CAG", b"A"], [b"AAG", b"CAAC"],
                   [b"AATGG", b"CCATTTTAGG"], [b"T", b"GATA", b"CCATAGG"]):
        h = hmm.build_hmm(motifs)
        out.append((h.num_states, h.ems, h.in_states, h.in_lps,
                    [(m.start_state, m.end_state, m.motif_index)
                     for m in h.motifs]))
        for rate in (0.0, 0.05, 0.2):
            q = noisy_repeat(rng, rng.choice(motifs), 12, rate).decode()
            labels = h.label(q)
            out.append(labels)
            out.append(hmm.calc_purity(q.encode(), h, list(motifs), labels))
            out.append(hmm.label_motifs(h, labels))
    return out


def case_decode_fast(pkg, tmp):
    hmm, fast = mod(pkg, "hmm"), mod(pkg, "hmm.decode_fast")
    rng = random.Random(6)
    out = []
    for motifs in ([b"CAG"], [b"AAG", b"CAAC"]):
        h = hmm.build_hmm(motifs)
        q = noisy_repeat(rng, motifs[0], 30, 0.1)
        labels = h.label(q.decode())
        out.append(fast.fast_calc_purity(q, h, list(motifs), labels))
        kept = fast.fast_remove_imperfect_motifs(h, list(motifs), labels,
                                                 q, 6)
        out.append(kept)
        out.append(hmm.collapse_labels(fast.fast_label_motifs(h, kept)))
    return out


def case_align_host(pkg, tmp):
    ah = mod(pkg, "kernels.align_host")
    rng = random.Random(7)
    out = []
    for i in range(40):
        a = random_dna(rng, 0 if i % 10 == 0 else 1, 90)
        b = bytearray(a) if i % 2 else bytearray(random_dna(rng, 1, 90))
        for _ in range(rng.randint(0, 4)):
            pos = rng.randrange(len(b) + 1)
            b[pos:pos + rng.randint(0, 1)] = random_dna(rng, 0, 1)
        b = bytes(b)
        out.append(ah.edit_distance(a, b))
        for scoring in ((2, 5, 1), (1, 0, 1)):
            out.append(ah.align_end_to_end(a, b, *scoring))
            out.append(ah.align_end_to_end_quadratic(a, b, *scoring))
            out.append(ah.align_ends_free_text(
                a[:40], random_dna(rng, 0, 30) + b + random_dna(rng, 0, 30),
                *scoring))
    return out


def case_align_banded_linear(pkg, tmp):
    banded = mod(pkg, "kernels.align_banded")
    linear = mod(pkg, "kernels.align_linear")
    rng = random.Random(8)
    out = []
    for _ in range(6):
        a = random_dna(rng, 150, 400)
        b = bytearray(a)
        for _ in range(rng.randint(0, 6)):
            pos = rng.randrange(len(b))
            b[pos:pos + rng.randint(0, 2)] = random_dna(rng, 0, 2)
        out.append(banded.align_end_to_end_banded(a, bytes(b), 2, 5, 1))
        out.append(linear.align_end_to_end_linear(a, bytes(b), 2, 5, 1))
    return out


def case_span_window(pkg, tmp):
    sw = mod(pkg, "kernels.span_window")
    ah = mod(pkg, "kernels.align_host")
    rng = random.Random(9)
    patterns, texts = [], []
    for i in range(12):
        p = random_dna(rng, 250, 250)
        core = noisy_repeat(rng, p, 1, rng.choice([0.0, 0.05, 0.3]))
        t = random_dna(rng, 0, 3000) + core + random_dna(rng, 0, 3000)
        if i % 5 == 0:
            t = random_dna(rng, 2000, 2000)
        patterns.append(p)
        texts.append(t)
    plans = [sw.plan_windows(p, t, 2, 5, 1) for p, t in zip(patterns, texts)]
    sub_p, sub_t, bands, owners = sw.expand(plans, patterns, texts)
    sub_results = []
    for p, t in zip(sub_p, sub_t):
        score, matches, _, tspan = ah.align_ends_free_text(p, t, 2, 5, 1)
        sub_results.append((score, matches, tspan))
    reduced = sw.reduce_and_certify(plans, owners, sub_results, len(texts),
                                    2, 5, 1)
    return [plans, sub_t, bands, owners, reduced]


def _flank_read(pkg, encoding):
    # ASCII read-encoding of tests/test_genotype.py::make_read
    HiFiRead = mod(pkg, "reads.hifi_read").HiFiRead
    seq_start = min(i for i, c in enumerate(encoding) if c in "ATGC")
    seq_end = max(i for i, c in enumerate(encoding) if c in "ATGC") + 1
    bases = encoding[seq_start:seq_end].encode()
    mismatches = [i - seq_start if i < seq_start else i - seq_end
                  for i, c in enumerate(encoding) if c == "X"]
    return HiFiRead(id="read", is_reverse=False, bases=bases,
                    quals=b"(" * len(bases), meth=None, read_qual=None,
                    mismatch_offsets=mismatches, start_offset=-seq_start,
                    end_offset=len(encoding) - seq_end, cigar=None,
                    hp_tag=None, mapq=60)


def case_genotypers(pkg, tmp):
    g = mod(pkg, "genotype")
    Ploidy = mod(pkg, "utils").Ploidy
    rng = random.Random(10)
    out = []
    for motif, (c1, c2) in ((b"CAG", (10, 25)), (b"AT", (12, 12)),
                            (b"GGC", (8, 60)), (b"AAAG", (20, 23))):
        trs = [noisy_repeat(rng, motif, c, 0.02).decode() or "A"
               for c in [c1] * 9 + [c2] * 11]
        for ploidy in (Ploidy.ONE, Ploidy.TWO):
            out.append(g.genotype_size.genotype(ploidy, trs))
            out.append(g.genotype_cluster.genotype(ploidy, trs))
    reads = [_flank_read(pkg, e) for e in [
        "XX====TATATATA===X===", "XX=X==TATATATA===X===",
        "XX====TATATATATA=X=X===", "XX====TATATATATA=X=X===",
        "XX====TATATATATA=X=X===", "XX====TATATATA===X==="]]
    out.append(g.genotype_flank.genotype(reads,
                                         [r.bases.decode() for r in reads]))
    return out


def case_clip(pkg, tmp):
    clip = mod(pkg, "reads.clip")
    hr = mod(pkg, "reads.hifi_read")

    def read(bases, meths, ref_pos, encoding):
        ops = [(int(n), op) for n, op in
               re.findall(r"(\d+)([MIDNSHP=X])", encoding)]
        return hr.HiFiRead(
            id="read1", is_reverse=False, bases=bases.encode(),
            quals=b"(" * len(bases), meth=bytes(meths), read_qual=None,
            mismatch_offsets=None, start_offset=0, end_offset=0,
            cigar=hr.Cigar(ref_pos=ref_pos, ops=ops), hp_tag=None, mapq=60)

    r1 = read("CGCTCGTTAAATCACG", [10, 20, 30], 10, "3=2D2=1X2=5I3=")
    r2 = read("AAAAACGCTCGTTAAATCACGAAAAAAAAAA", [10, 20, 30], 10,
              "5S3=2D2=1X2=5I3=10S")
    out = [clip.clip_to_region(r, region) for r in (r1, r2)
           for region in ((0, 10), (0, 15), (12, 17), (9, 23), (14, 40),
                          (23, 33))]
    out += [clip.clip_bases(r, left, right) for r in (r1, r2)
            for left, right in ((0, 0), (2, 3), (5, 5), (20, 0))]
    return out


def case_rand_rs(pkg, tmp):
    rs = mod(pkg, "utils.rand_rs")
    out = []
    for seed in (0, 42, 2 ** 40 + 7):
        rng = rs.StdRng.seed_from_u64(seed)
        out.append([rng.next_u32() for _ in range(40)])
        out.append([rng.next_u64() for _ in range(40)])
        out.append([rng.random_range(n) for n in (1, 2, 7, 250, 10 ** 6)
                    for _ in range(8)])
    return out


def case_utils(pkg, tmp):
    u = mod(pkg, "utils")
    k = u.Karyotype.new("XY")
    return [u.TrgtScoring.from_string("1,0,1"),
            u.Genotyper.from_str("cluster"),
            [k.get_ploidy(c) for c in ("chr1", "chrX", "chrY", "X", "7")],
            u.GenomicRegion.from_string("chr2:100-2000")]


def _dataset(pkg, tmp):
    synth = mod(pkg, "utils.synth")
    d = os.path.join(tmp, pkg)
    os.makedirs(d, exist_ok=True)
    loci = synth.hetero_loci(3, seed=4) + synth.adversarial_loci(2)
    return synth.make_dataset(d, loci, seed=4, depth=8,
                              read_mutator=synth.adversarial_mutator)


def case_synth_files(pkg, tmp):
    """`make_dataset` writes the same FASTA, BED and (BGZF) BAM bytes and
    BAI index: the BamWriter and BgzfWriter copies included."""
    fasta, bed, bam = _dataset(pkg, tmp)
    return [open(p, "rb").read() for p in (fasta, bed, bam, bam + ".bai")]


def case_workflow_and_writers(pkg, tmp):
    """Catalog, FASTA and BAM readers, the per-locus host workflow, and
    the VCF and spanning-BAM writers: the bytes of both output files."""
    io, utils = mod(pkg, "io"), mod(pkg, "utils")
    wf = mod(pkg, "engine.workflow")
    bam_write = mod(pkg, "io.bam_write")
    fasta, bed, bam_path = _dataset(pkg, tmp)
    genome = io.FastaReader(fasta)
    bam = io.BamReader(bam_path)
    prefix = os.path.join(tmp, pkg, "out")
    vcf = io.VcfWriter(prefix + ".vcf.gz", "synth", bam.header.references,
                       "cmd", "1.0")
    out_bam = io.BamWriter(prefix + ".bam", bam.header.text,
                           bam.header.references)
    summary = []
    for genotyper, rq in (("size", 0.98), ("cluster", -1.0)):
        params = wf.Params(min_flank_id_frac=0.7, min_read_qual=rq,
                           search_flank_len=250, max_depth=250)
        for locus in io.iter_loci(bed, genome, utils.Karyotype.new("XX"),
                                  250, utils.Genotyper.from_str(genotyper)):
            result = wf.analyze_tr(locus, params, bam)
            vcf.write(locus, result)
            summary.append((locus.id, [a.seq for a in result.genotype],
                            result.classification, result.tr_spans))
            for i, read in enumerate(result.reads):
                rec, ref_end = bam_write.build_record(
                    read.id, 0, 0, read.cigar.ref_pos, read.mapq,
                    read.cigar.ops, read.bases.decode(), read.quals,
                    [("TR", "Z", locus.id), ("AL", "i",
                                             result.classification[i])])
                out_bam.write_encoded(rec, 0, read.cigar.ref_pos, ref_end)
    vcf.close()
    out_bam.close()
    assert len(summary) == 10 and any(len(s[1]) == 2 for s in summary)
    return [summary, open(prefix + ".vcf.gz", "rb").read(),
            open(prefix + ".bam", "rb").read(),
            io.BgzfReader(prefix + ".vcf.gz").read_all()]


def case_native_codec(pkg, tmp):
    """The host codec built from each package's own source answers alike
    (or both are absent and the pure-Python paths ran above)."""
    native = mod(pkg, "io.native")
    if native.get_lib() is None:
        return None
    rng = random.Random(12)
    p, t = random_dna(rng, 200, 200), random_dna(rng, 900, 900)
    t = t[:300] + p[:120] + p[125:] + t[300:]
    return [native.endsfree_align(p, t, 2, 5, 1),
            native.endsfree_banded(p, t, 2, 5, 1, 200, 400),
            native.banded_align(p, t[280:520], 2, 5, 1, 5, 5, 32)]


CASES = [case_hmm, case_decode_fast, case_align_host,
         case_align_banded_linear, case_span_window, case_genotypers,
         case_clip, case_rand_rs, case_utils, case_synth_files,
         case_workflow_and_writers, case_native_codec]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_copy_matches_original(case, tmp_path):
    port, original = (plain(case(pkg, str(tmp_path))) for pkg in PACKAGES)
    assert port == original


def test_native_codec_builds_from_the_port_source():
    """The port's codec comes from trgt_tpu_torch/csrc/bamcodec.cpp, the
    same bytes as the original source, and lands in the port's build
    directory, never in native/."""
    native = importlib.import_module("trgt_tpu_torch.io.native")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native._SRC == os.path.join(repo, "trgt_tpu_torch", "csrc",
                                       "bamcodec.cpp")
    with open(native._SRC, "rb") as a, \
            open(os.path.join(repo, "native", "bamcodec.cpp"), "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(native._library_path()) == os.path.join(
        repo, "build", "trgt_tpu_torch")


def test_bucket_copy():
    port = importlib.import_module("trgt_tpu_torch.kernels.bucket")
    original = importlib.import_module("trgt_tpu.kernels.bucket")
    for minimum in (8, 64, 128):
        assert [port.bucket(n, minimum) for n in range(0, 3000, 7)] == \
            [original.bucket(n, minimum) for n in range(0, 3000, 7)]
    assert list(port.chunk_ranges(1100, 512)) == \
        list(original.chunk_ranges(1100, 512))
    assert not hasattr(port, "const_cells_batch")


def test_version_copy():
    import trgt_tpu
    import trgt_tpu_torch
    assert trgt_tpu_torch.FULL_VERSION == trgt_tpu.FULL_VERSION
