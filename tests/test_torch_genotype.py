"""End-to-end parity of the port: `trgt_tpu_torch genotype` with
`--device cpu` (the kernels' plain PyTorch versions) and `--device host`
(the host twins) must write the same VCF records and spanning-BAM records
as `trgt_tpu genotype --device host` on the same synthetic data, for the
size and cluster genotypers and the targeted preset."""

import logging
import os
import struct

import pytest
import torch

from trgt_tpu.cli import main as trgt_tpu_main
from trgt_tpu.io.bam import BamReader
from trgt_tpu.io.bam_write import BamWriter
from trgt_tpu.io.bgzf import BgzfReader
from trgt_tpu.utils.synth import (SynthLocus, adversarial_loci,
                                  adversarial_mutator, make_dataset)
from trgt_tpu_torch import device as device_mod
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.engine import pipeline as port_pipeline
from trgt_tpu_torch.engine import runner as port_runner

# the plain versions issue many tiny ops: with several test workers on
# one machine, more than one intra-op thread each oversubscribes the cores
torch.set_num_threads(1)


def records(prefix):
    """(VCF lines after the ## header, spanning-BAM bytes after the BAM
    header): the headers carry the command line, which differs."""
    vcf = [line for line in BgzfReader(prefix + ".vcf.gz").read_all()
           .decode().splitlines() if not line.startswith("##")]
    data = BgzfReader(prefix + ".spanning.bam").read_all()
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4 + l_name + 4
    return vcf, data[off:]


def genotype(main, dataset, name, extra):
    td, fasta, bed, bam = dataset
    prefix = os.path.join(td, name)
    rc = main(["genotype", "--genome", fasta, "--repeats", bed, "--reads",
               bam, "--output-prefix", prefix, *extra])
    assert rc == 0
    return records(prefix)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    # the loci of tests/test_synthetic_e2e.py::test_multi_locus_calls
    td = str(tmp_path_factory.mktemp("torch_synth"))
    loci = [SynthLocus("HOM", "CAG", 15, (15, 15)),
            SynthLocus("HET", "CAG", 10, (10, 20)),
            SynthLocus("EXP", "GGC", 8, (8, 60)),
            SynthLocus("REF", "AT", 12, (12, 12))]
    return (td, *make_dataset(td, loci, depth=20))


@pytest.fixture(scope="module")
def adversarial(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("torch_adv"))
    return (td, *make_dataset(td, adversarial_loci(6), seed=7,
                              read_mutator=adversarial_mutator))


@pytest.fixture(scope="module")
def low_quality(adversarial):
    """The adversarial reads with read quality 0.85: below 0.9, so the
    targeted preset's impure-read filter labels every spanning read."""
    td, fasta, bed, bam = adversarial
    src = BamReader(bam)
    out = os.path.join(td, "low_rq.bam")
    w = BamWriter(out, src.header.text, src.header.references,
                  build_index=True)
    for rec in src:
        w.write_record(rec.qname, rec.flag, rec.ref_id, rec.pos, rec.mapq,
                       rec.cigar, rec.seq, rec.qual, [("rq", "f", 0.85)])
    w.close()
    return td, fasta, bed, out


@pytest.fixture(scope="module")
def half_low_quality(adversarial):
    """The adversarial reads with every second read's quality at 0.85:
    the filter labels half of the spanning reads, and the cluster
    genotyper sees reads of both kinds."""
    td, fasta, bed, bam = adversarial
    src = BamReader(bam)
    out = os.path.join(td, "half_low_rq.bam")
    w = BamWriter(out, src.header.text, src.header.references,
                  build_index=True)
    for i, rec in enumerate(src):
        w.write_record(rec.qname, rec.flag, rec.ref_id, rec.pos, rec.mapq,
                       rec.cigar, rec.seq, rec.qual,
                       [("rq", "f", 0.85 if i % 2 else 0.999)])
    w.close()
    return td, fasta, bed, out


@pytest.fixture
def genotype_stage_calls(monkeypatch):
    """Counts the pairs and problems the port's pipeline sends to its
    edit-distance and end-to-end alignment modules."""
    seen = {"editdist": 0, "e2e": 0}
    orig_ed = port_pipeline.edit_distances_batch
    orig_e2e = port_pipeline.e2e_align_batch

    def spy_ed(pairs, device):
        seen["editdist"] += len(pairs)
        return orig_ed(pairs, device)

    def spy_e2e(problems, mism, gapo, gape, device):
        seen["e2e"] += len(problems)
        return orig_e2e(problems, mism, gapo, gape, device)

    monkeypatch.setattr(port_pipeline, "edit_distances_batch", spy_ed)
    monkeypatch.setattr(port_pipeline, "e2e_align_batch", spy_e2e)
    return seen


@pytest.fixture
def viterbi_queries(monkeypatch):
    """Counts the queries the port's pipeline sends to its Viterbi."""
    seen = []
    orig = port_pipeline.viterbi_batch_multi

    def spy(hmms, queries, device):
        seen.append(len(queries))
        return orig(hmms, queries, device)

    monkeypatch.setattr(port_pipeline, "viterbi_batch_multi", spy)
    return seen


@pytest.mark.parametrize("port_device", ["cpu", "host"])
def test_targeted_preset_matches_trgt_tpu_host(low_quality, port_device,
                                               viterbi_queries):
    extra = ["--preset", "targeted"]
    want = genotype(trgt_tpu_main, low_quality, "ref_targeted",
                    extra + ["--device", "host"])
    got = genotype(port_main, low_quality, f"port_targeted_{port_device}",
                   extra + ["--device", port_device])
    n_loci = len(want[0]) - 1
    assert n_loci > 1 and len(want[1]) > 0
    assert got == want
    if port_device == "cpu":
        # the impure-read filter went through the port's Viterbi: more
        # queries than the annotate stage's two alleles per locus
        assert sum(viterbi_queries) > 2 * n_loci


@pytest.mark.parametrize("port_device", ["cpu", "host"])
def test_targeted_preset_half_low_quality_matches_trgt_tpu_host(
        half_low_quality, port_device, genotype_stage_calls):
    extra = ["--preset", "targeted"]
    want = genotype(trgt_tpu_main, half_low_quality, "ref_half",
                    extra + ["--device", "host"])
    got = genotype(port_main, half_low_quality, f"port_half_{port_device}",
                   extra + ["--device", port_device])
    assert len(want[0]) > 2 and len(want[1]) > 0
    assert got == want
    if port_device == "cpu":
        # the cluster distances and the consensus alignments went through
        # the port's editdist and e2e modules (their plain versions)
        assert genotype_stage_calls["editdist"] > 0
        assert genotype_stage_calls["e2e"] > 0
    else:
        assert genotype_stage_calls == {"editdist": 0, "e2e": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("data,preset", [("adversarial", "wgs"),
                                         ("low_quality", "targeted"),
                                         ("half_low_quality", "targeted")])
def test_cuda_matches_port_host(request, data, preset):
    # wgs drops reads under rq 0.98, so it gets the unmodified reads
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trgt_tpu_torch.kernels import telemetry
    dataset = request.getfixturevalue(data)
    kernels = ["flank", "viterbi", "e2e"]
    if preset == "targeted":
        kernels.append("editdist")     # the cluster genotyper's distances

    def launches():
        totals = telemetry.totals(telemetry.snapshot())
        return [totals.get(k, {}).get("launches", 0) for k in kernels]

    before = launches()
    extra = ["--preset", preset]
    got = genotype(port_main, dataset, f"port_{data}_cuda",
                   extra + ["--device", "cuda"])
    assert all(n > b for n, b in zip(launches(), before))
    want = genotype(port_main, dataset, f"port_{data}_host",
                    extra + ["--device", "host"])
    assert len(want[0]) > 1 and len(want[1]) > 0
    assert got == want


@pytest.mark.parametrize("port_device", ["cpu", "host"])
@pytest.mark.parametrize("data,genotyper", [("synthetic", "size"),
                                            ("adversarial", "size"),
                                            ("adversarial", "cluster")])
def test_port_matches_trgt_tpu_host(request, data, genotyper, port_device):
    dataset = request.getfixturevalue(data)
    extra = ["--genotyper", genotyper]
    want = genotype(trgt_tpu_main, dataset, f"ref_{genotyper}",
                    extra + ["--device", "host"])
    got = genotype(port_main, dataset, f"port_{genotyper}_{port_device}",
                   extra + ["--device", port_device])
    assert len(want[0]) > 1 and len(want[1]) > 0
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_threads_and_batches_keep_records(synthetic):
    want = genotype(port_main, synthetic, "port_t1", ["--device", "cpu"])
    got = genotype(port_main, synthetic, "port_t3",
                   ["--device", "cpu", "-t", "3", "--batch-size", "2"])
    assert got == want


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device("cuda")


def test_cuda_run_without_a_card_fails(monkeypatch, synthetic):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    td, fasta, bed, bam = synthetic
    prefix = os.path.join(td, "port_nocard")
    rc = port_main(["genotype", "--genome", fasta, "--repeats", bed,
                    "--reads", bam, "--output-prefix", prefix])
    assert rc == 1
    assert not os.path.exists(prefix + ".vcf.gz")


def test_device_modes():
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    assert device_mod.resolve_device("host") is None
    with pytest.raises(ValueError):
        device_mod.resolve_device("tpu")


# the cases of tests/test_synthetic_e2e.py:89-131: a haploid chrX locus
# under --karyotype XY, a zero-ploidy chrY locus under XX, a karyotype
# file, and bad catalog lines (start >= end; a contig the FASTA lacks)
PLOIDY_CASES = {
    "xy_haploid": ("chrX", SynthLocus("X1", "CAG", 10, (14, 14)),
                   ["--karyotype", "XY"], "1"),
    "zero_ploidy": ("chrY", SynthLocus("Y1", "CAG", 10, (10, 10)), [],
                    "./."),
    "karyotype_file": ("chrQ", SynthLocus("C1", "CAG", 10, (13, 13)),
                       ["--karyotype", "{td}/karyo.txt"], "1"),
    "bad_catalog_lines": ("chrS", SynthLocus("OK", "CAG", 10, (10, 10)), [],
                          "0/0"),
}
BAD_LINES = ("chrS\t10\t5\tID=BAD;MOTIFS=CAG;STRUC=<TR>\n"
             "chrMISSING\t500\t600\tID=BAD2;MOTIFS=CAG;STRUC=<TR>\n")


@pytest.fixture(scope="module")
def ploidy_datasets(tmp_path_factory):
    out = {}
    for case, (chrom, locus, extra, _gt) in PLOIDY_CASES.items():
        td = str(tmp_path_factory.mktemp(f"torch_{case}"))
        fasta, bed, bam = make_dataset(td, [locus], depth=10, chrom=chrom)
        with open(os.path.join(td, "karyo.txt"), "w") as fh:
            fh.write("chrQ 1\n")
        if case == "bad_catalog_lines":
            with open(bed, "a") as fh:
                fh.write(BAD_LINES)
        out[case] = ((td, fasta, bed, bam),
                     [x.format(td=td) for x in extra])
    return out


@pytest.mark.parametrize("port_device", ["cpu", "host"])
@pytest.mark.parametrize("case", list(PLOIDY_CASES))
def test_ploidy_and_catalog_cases_match_trgt_tpu_host(ploidy_datasets,
                                                      case, port_device):
    dataset, extra = ploidy_datasets[case]
    want = genotype(trgt_tpu_main, dataset, f"ref_{case}",
                    extra + ["--device", "host"])
    got = genotype(port_main, dataset, f"port_{case}_{port_device}",
                   extra + ["--device", port_device])
    assert got == want
    # one record: the bad lines are skipped, the zero-ploidy locus is
    # written without a call
    assert len(want[0]) == 2
    sample = dict(zip(want[0][1].split("\t")[8].split(":"),
                      want[0][1].split("\t")[9].split(":")))
    assert sample["GT"] == PLOIDY_CASES[case][3]


def test_pool_counts_catalog_errors_as_t1(ploidy_datasets, caplog,
                                          monkeypatch):
    """Every worker parses the whole catalog; the parent reports the
    errors of one pass, as `-t 1` does."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(port_runner, "POOL_MIN_LOCI", 0)
    dataset, _extra = ploidy_datasets["bad_catalog_lines"]
    caplog.set_level(logging.INFO, logger="trgt")
    counts = []
    for threads in ("1", "3"):
        caplog.clear()
        got = genotype(port_main, dataset, f"port_errors_t{threads}",
                       ["--device", "host", "-t", threads])
        counts += [r.getMessage() for r in caplog.records
                   if r.getMessage().startswith("Processed")]
    assert counts == ["Processed 1 loci (2 errors)"] * 2
    assert got == genotype(trgt_tpu_main, dataset, "ref_errors",
                           ["--device", "host"])


@pytest.fixture(scope="module")
def seven_loci(tmp_path_factory):
    # the loci of tests/test_synthetic_e2e.py:148-168
    td = str(tmp_path_factory.mktemp("torch_shards"))
    loci = [SynthLocus(f"S{i}", "CAG", 10 + i, (10 + i, 10 + i))
            for i in range(7)]
    return (td, *make_dataset(td, loci, depth=8))


@pytest.mark.parametrize("port_device", ["cpu", "host"])
def test_catalog_shards_cover_the_full_run(seven_loci, port_device):
    """3-way `--shard-index/--shard-count`: each shard equals
    `trgt_tpu`'s, and the shards' records together are the full run's."""
    full = genotype(port_main, seven_loci, f"port_full_{port_device}",
                    ["--device", port_device])
    union = []
    for shard in range(3):
        extra = ["--shard-index", str(shard), "--shard-count", "3"]
        got = genotype(port_main, seven_loci,
                       f"port_shard{shard}_{port_device}",
                       extra + ["--device", port_device])
        want = genotype(trgt_tpu_main, seven_loci, f"ref_shard{shard}",
                        extra + ["--device", "host"])
        assert got == want
        assert got[0][0] == full[0][0]                  # the #CHROM line
        union += got[0][1:]
    assert sorted(union) == sorted(full[0][1:])
    assert len(union) == 7
