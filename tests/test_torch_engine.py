"""The per-locus `analyze_tr` with the port's `DeviceEngine`: its device
hooks (flank spans, Viterbi labels, the cluster genotyper's distance
matrix) give the same results as `analyze_tr` without an engine (the host
twins), and as `trgt_tpu`'s `analyze_tr` with `trgt_tpu`'s
`DeviceEngine()` (the check of tests/test_engine_device_path.py, on
synthetic data)."""

import pytest
import torch

from trgt_tpu.engine.batch import DeviceEngine as RefEngine
from trgt_tpu.engine.workflow import Params as RefParams
from trgt_tpu.engine.workflow import analyze_tr as ref_analyze_tr
from trgt_tpu.io.bam import BamReader as RefBamReader
from trgt_tpu.io.catalog import iter_loci as ref_iter_loci
from trgt_tpu.io.fasta import FastaReader as RefFastaReader
from trgt_tpu.utils import Genotyper as RefGenotyper
from trgt_tpu.utils import Karyotype as RefKaryotype
from trgt_tpu.utils import TrgtScoring as RefScoring
from trgt_tpu_torch.engine.batch import DeviceEngine, make_engine
from trgt_tpu_torch.engine.workflow import Params, analyze_tr
from trgt_tpu_torch.io.bam import BamReader
from trgt_tpu_torch.io.catalog import iter_loci
from trgt_tpu_torch.io.fasta import FastaReader
from trgt_tpu_torch.kernels import telemetry
from trgt_tpu_torch.utils import Genotyper, Karyotype, TrgtScoring
from trgt_tpu_torch.utils.synth import SynthLocus, make_dataset

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Reads with 2 % errors (spans miss the exact path, the cluster
    genotyper sees many distinct TR strings), a two-motif locus and an
    expansion."""
    td = str(tmp_path_factory.mktemp("torch_engine"))
    loci = [SynthLocus("HET", "CAG", 10, (10, 20)),
            SynthLocus("EXP", "GGC", 8, (8, 40)),
            SynthLocus("MIX", "CAG", 12, (12, 16), motifs="CAG,CAA"),
            SynthLocus("AT", "AT", 12, (12, 15))]
    return make_dataset(td, loci, depth=14, error_rate=0.02, seed=5)


def summary(res):
    return ([(a.seq, a.ci, a.num_spanning, a.annotation.motif_counts,
              a.annotation.purity) for a in res.genotype],
            res.tr_spans, res.classification)


def port_results(dataset, genotyper, engine):
    fasta, bed, bam = dataset
    params = Params(min_flank_id_frac=0.7, min_read_qual=0.98,
                    search_flank_len=250, max_depth=250,
                    aln_scoring=TrgtScoring(2, 5, 1))
    loci = iter_loci(bed, FastaReader(fasta), Karyotype.new("XX"), 250,
                     Genotyper.from_str(genotyper))
    reader = BamReader(bam)
    return [summary(analyze_tr(locus, params, reader, engine))
            for locus in loci]


def ref_results(dataset, genotyper):
    fasta, bed, bam = dataset
    params = RefParams(min_flank_id_frac=0.7, min_read_qual=0.98,
                       search_flank_len=250, max_depth=250,
                       aln_scoring=RefScoring(2, 5, 1))
    loci = ref_iter_loci(bed, RefFastaReader(fasta), RefKaryotype.new("XX"),
                         250, RefGenotyper.from_str(genotyper))
    reader = RefBamReader(bam)
    return [summary(ref_analyze_tr(locus, params, reader, RefEngine()))
            for locus in loci]


@pytest.mark.parametrize("genotyper", ["size", "cluster"])
def test_engine_matches_host_and_trgt_tpu(dataset, genotyper):
    before = telemetry.snapshot()
    got = port_results(dataset, genotyper, DeviceEngine(CPU))
    calls = {k: v.get("calls", 0) - before.get(k, {}).get("calls", 0)
             for k, v in telemetry.snapshot().items()}
    # the hooks went through the port's kernel modules
    assert calls["flank"] > 0 and calls["viterbi"] > 0
    if genotyper == "cluster":
        assert calls["editdist"] > 0
    assert len(got) == 4 and all(s[0] for s in got)
    assert got == port_results(dataset, genotyper, None)
    assert got == ref_results(dataset, genotyper)


def test_make_engine():
    assert make_engine(None) is None
    assert make_engine(CPU).device == CPU


@pytest.mark.cuda
@pytest.mark.parametrize("genotyper", ["size", "cluster"])
def test_cuda_engine_matches_host(dataset, genotyper):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = telemetry.snapshot()
    got = port_results(dataset, genotyper,
                       DeviceEngine(torch.device("cuda")))
    launched = {k: v.get("launches", 0) - before.get(k, {}).get(
        "launches", 0) for k, v in telemetry.snapshot().items()}
    assert launched["flank"] > 0 and launched["viterbi"] > 0
    if genotyper == "cluster":
        assert launched["editdist"] > 0
    assert got == port_results(dataset, genotyper, None)


@pytest.mark.cuda
def test_cuda_pipeline_hands_back_the_allocator_cache(dataset):
    """ROADMAP C10: `BatchPipeline` empties the CUDA caching allocator's
    cache after each batch's device stages, so a run of several batches
    leaves no more reserved than there was before it, though the batches
    did reserve memory on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trgt_tpu_torch.engine.pipeline import BatchPipeline
    fasta, bed, bam = dataset
    dev = torch.device("cuda")
    params = Params(min_flank_id_frac=0.7, min_read_qual=0.98,
                    search_flank_len=250, max_depth=250,
                    aln_scoring=TrgtScoring(2, 5, 1))
    loci = iter_loci(bed, FastaReader(fasta), Karyotype.new("XX"), 250,
                     Genotyper.from_str("cluster"))
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = list(BatchPipeline(params, dev, batch_size=1).process(
        loci, BamReader(bam)))
    assert len(got) == 4
    assert torch.cuda.max_memory_reserved(dev) > reserved
    assert torch.cuda.memory_reserved(dev) == reserved
