"""The port keeps its own copies of the JAX package's numpy/stdlib modules
(trgt_tpu_torch/{utils,io,reads,hmm,genotype,kernels,engine,merge,plot}).
Each copy
is held against its original on seeded inputs: one parametrised test, one
case per group of modules, every comparison exact."""

import contextlib
import dataclasses
import gzip
import importlib
import io as std_io
import os
import random
import re
from types import SimpleNamespace
from unittest import mock

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


def case_bcf(pkg, tmp):
    """BcfWriter bytes, compressed and not, with ints, floats, strings,
    genotypes and missing values; both readers' records of them."""
    bcf = mod(pkg, "io.bcf")
    rng = random.Random(13)
    header = ["##fileformat=VCFv4.2",
              '##FILTER=<ID=PASS,Description="All filters passed">',
              '##INFO=<ID=TRID,Number=1,Type=String,Description="x">',
              '##INFO=<ID=END,Number=1,Type=Integer,Description="x">',
              '##FORMAT=<ID=GT,Number=1,Type=String,Description="x">',
              '##FORMAT=<ID=AL,Number=.,Type=Integer,Description="x">',
              '##FORMAT=<ID=MC,Number=.,Type=String,Description="x">',
              '##FORMAT=<ID=AP,Number=.,Type=Float,Description="x">',
              "##contig=<ID=c1,length=100000>",
              "##contig=<ID=c2,length=100000>",
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
              "\ts1\ts2\ts3"]
    out = []
    for uncompressed in (False, True):
        path = os.path.join(tmp, f"{pkg}_{uncompressed}.bcf")
        w = bcf.BcfWriter(path, header, uncompressed=uncompressed)
        pos = 0
        for i in range(30):
            pos += rng.randint(1, 5000)
            alleles = [random_dna(rng, 1, 12).decode()
                       for _ in range(rng.randint(1, 4))]
            gts = [[(rng.choice([None, *range(len(alleles))]), k > 0
                     and rng.random() < 0.3) for k in range(rng.randint(1, 2))]
                   for _ in range(3)]
            als = [[rng.choice([bcf.INT32_MISSING, rng.randint(0, 70000)])
                    for _ in range(rng.randint(1, 3))] for _ in range(3)]
            aps = [[rng.choice([None, rng.random()])
                    for _ in range(rng.randint(1, 2))] for _ in range(3)]
            mcs = [rng.choice([".", "12_3", "4,5"]) for _ in range(3)]
            w.write_record(
                chrom="c1" if i < 20 else "c2", pos=pos, rid=".",
                alleles=alleles, qual=None,
                info=[("TRID", f"T{i}"), ("END", pos + 40)],
                fmt=[("GT", bcf.BcfWriter.encode_format_gt(gts)),
                     ("AL", bcf.BcfWriter.encode_format_ints(als)),
                     ("MC", bcf.BcfWriter.encode_format_strings(mcs)),
                     ("AP", bcf.BcfWriter.encode_format_floats(aps))],
                n_sample=3)
        w.close()
        out.append(open(path, "rb").read())
        out.append(list(bcf.BcfReader(path).records()))
        if not uncompressed:
            out.append(list(bcf.BcfStreamReader(path).records()))
    out += [bcf.FLOAT_MISSING, bcf.FLOAT_EOV, bcf.INT32_MISSING]
    return out


def case_cram_write(pkg, tmp):
    """CramWriter bytes (and .crai) of the synthetic BAM; rANS order 0
    and 1 and ITF8/LTF8 encodings. The file ID is the path's last 20
    bytes and gzip stamps the time: both are pinned."""
    cw = mod(pkg, "io.cram_write")
    fasta, _bed, bam_path = _dataset(pkg, tmp)
    bam = mod(pkg, "io").BamReader(bam_path)
    path = os.path.join(tmp, pkg, "reads_of_the_sample.cram")
    with mock.patch.object(gzip, "time", SimpleNamespace(time=lambda: 0.0)):
        w = cw.CramWriter(path, bam.header.text, bam.header.references,
                          fasta)
        for rec in bam:
            aux = [(tag, "f" if isinstance(v, float) else "i"
                    if isinstance(v, int) else "B" if isinstance(v, tuple)
                    else "Z", v) for tag, v in rec.aux().items()]
            w.write_record(rec.qname, rec.flag, rec.ref_id, rec.pos,
                           rec.mapq, rec.cigar, rec.seq, rec.qual, aux)
        w.close()
    rng = random.Random(14)
    data = bytes(rng.choice(b"ACGT") for _ in range(3000)) + \
        bytes(rng.randrange(256) for _ in range(500))
    return [open(path, "rb").read(), open(path + ".crai", "rb").read(),
            cw.rans_encode(data, 0), cw.rans_encode(data, 1),
            [cw.itf8(v) for v in (0, 127, 128, 1 << 20, -1)],
            [cw.ltf8(v) for v in (0, 1 << 35, (1 << 63) - 1, -1)]]


def _vcf_texts(tmp, pkg, rng):
    """Three single-sample VCFs over two contigs: shared and private
    sites, alleles and genotypes per sample, missing values."""
    paths = []
    for s in range(3):
        lines = ["##fileformat=VCFv4.2",
                 '##INFO=<ID=TRID,Number=1,Type=String,Description="x">',
                 '##INFO=<ID=END,Number=1,Type=Integer,Description="x">',
                 '##INFO=<ID=MOTIFS,Number=.,Type=String,Description="x">',
                 '##INFO=<ID=STRUC,Number=1,Type=String,Description="x">']
        lines += [f'##FORMAT=<ID={k},Number=.,Type={t},Description="x">'
                  for k, t in (("GT", "String"), ("AL", "Integer"),
                               ("ALLR", "String"), ("SD", "Integer"),
                               ("MC", "String"), ("MS", "String"),
                               ("AP", "Float"), ("AM", "Float"))]
        lines += ["##contig=<ID=c1,length=100000>",
                  "##contig=<ID=c2,length=100000>",
                  "##trgtVersion=3.0.0-tpu",
                  "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                  f"FORMAT\ts{s}"]
        for contig in ("c1", "c2"):
            for site in range(12):
                if rng.random() < 0.25:
                    continue
                ref = "A" + "CAG" * (3 + site % 4)
                alts = sorted({"A" + "CAG" * rng.randint(1, 9)
                               for _ in range(rng.randint(0, 2))} - {ref})
                n = len(alts) + 1
                gt = rng.choice(["./.", f"0/{n - 1}", f"{n - 1}|0", "0"])
                am = rng.choice([".,.", f"{rng.random():.6f},0.500000"])
                lines.append(
                    f"{contig}\t{1000 * site + 1}\t.\t{ref}\t"
                    f"{','.join(alts) or '.'}\t.\t.\t"
                    f"TRID={contig}_{site};END={1000 * site + len(ref)};"
                    f"MOTIFS=CAG;STRUC=<TR>\tGT:AL:ALLR:SD:MC:MS:AP:AM\t"
                    f"{gt}:{len(ref)},{rng.randint(3, 30)}:1-2,3-4:5,6:"
                    f"3,4:0(0-9),0(0-12):1.000000,0.9:{am}")
        path = os.path.join(tmp, f"{pkg}_s{s}.vcf")
        open(path, "w").write("\n".join(lines) + "\n")
        paths.append(path)
    return paths


def case_merge(pkg, tmp):
    """run_merge of seeded VCFs to every output type and back from BCF;
    the streaming reader's records of each input."""
    runner = mod(pkg, "merge.runner")
    vcf_text = mod(pkg, "merge.vcf_text")
    paths = _vcf_texts(tmp, pkg, random.Random(15))
    out = [[list(vcf_text.VcfTextReader(p).records(c))
            for c in ("c1", "c2")] for p in paths]
    for out_type in "vzbu":
        target = os.path.join(tmp, f"{pkg}_merged.{out_type}")
        runner.run_merge(SimpleNamespace(
            vcfs=paths, vcf_list=None, genome_path=None, output=target,
            output_type=out_type, skip_n=None, process_n=None,
            print_header=False, force_single=False, force_samples=False,
            no_version=True, missing_to_ref=False, strategy="exact",
            quit_on_errors=False, contigs=None))
        out.append(open(target, "rb").read())
    return out


def case_plot(pkg, tmp):
    """Allele and waterfall scenes of seeded reads (with methylation) over
    a two-motif locus: segmentations, SVG text, PDF and PNG bytes."""
    inp, align = mod(pkg, "plot.input"), mod(pkg, "plot.align")
    plots, pipeplot = mod(pkg, "plot.plots"), mod(pkg, "plot.pipeplot")
    params = mod(pkg, "plot.params")
    rng = random.Random(16)
    lf, rf = (random_dna(rng, 50, 50).decode() for _ in range(2))
    motifs = ["CAG", "CCG"]
    locus = inp.PlotLocus(
        id="P1", struc="<TR>", motifs=motifs, left_flank=lf, right_flank=rf,
        region=mod(pkg, "utils").GenomicRegion.from_string("c1:1000-1050"))
    alleles = ["CAG" * 6 + "CCG" * 4, "CAG" * 9 + "CCG" * 5]
    reads = []
    for i in range(12):
        tr = noisy_repeat(rng, alleles[i % 2].encode(), 1, 0.04).decode()
        cut_l, cut_r = rng.randint(0, 20), rng.randint(0, 20)
        seq = lf[cut_l:] + tr + rf[:len(rf) - cut_r]
        betas = [align.Beta(pos=p, value=rng.random())
                 for p in range(len(seq) - 1) if seq[p:p + 2] == "CG"]
        reads.append(inp.PlotRead(read_name=f"r{i}", seq=seq,
                                  left_flank=len(lf) - cut_l,
                                  right_flank=len(rf) - cut_r,
                                  allele=i % 2, betas=betas))
    out = [align.align_motifs([m.encode() for m in motifs], a)
           for a in alleles]
    for show in ("motifs", "meth"):
        for squished in (False, True):
            p = params.pick_params(motifs, squished)
            scenes = [plots.plot_alleles(locus, show,
                                         [lf + a + rf for a in alleles],
                                         reads, p),
                      plots.plot_waterfall(locus, show, reads, p)]
            out += [pipeplot.generate_string(sc) for sc in scenes]
    for ext in ("pdf", "png"):
        path = os.path.join(tmp, f"{pkg}.{ext}")
        pipeplot.generate_image(scenes[0], path)
        out.append(open(path, "rb").read())
    return out


def case_validate(pkg, tmp):
    """run_validate's stdout and stderr on the synthetic catalog with a
    few bad lines."""
    validate = mod(pkg, "engine.validate")
    fasta, bed, _bam = _dataset(pkg, tmp)
    bad = os.path.join(tmp, pkg, "bad.bed")
    good = open(bed).read().splitlines()
    open(bad, "w").write("\n".join(good[:2] + [
        "chrZ\t10\t20\tID=X;MOTIFS=CA;STRUC=<TR>",
        "chrS\t50\t40\tID=Y;MOTIFS=CA;STRUC=<TR>"] + good[2:]) + "\n")
    out = []
    for catalog, flank in ((bed, 250), (bad, 250), (bed, 100000)):
        stdout, stderr = std_io.StringIO(), std_io.StringIO()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            validate.run_validate(SimpleNamespace(
                genome_path=fasta, repeats_path=catalog, flank_len=flank))
        out.append((stdout.getvalue(), stderr.getvalue()))
    return out


CASES = [case_hmm, case_decode_fast, case_align_host,
         case_align_banded_linear, case_span_window, case_genotypers,
         case_clip, case_rand_rs, case_utils, case_synth_files,
         case_workflow_and_writers, case_native_codec, case_bcf,
         case_cram_write, case_merge, case_plot, case_validate]


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
