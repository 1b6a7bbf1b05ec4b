"""CRAM input of the port: its own CRAM writer (`trgt_tpu_torch.io.cram_write`)
against its own reader and native rANS decoder, CRAM records against the
BAM they were written from, and `genotype` from a CRAM under `--device cpu`
and `--device host` against the same reads from the BAM and against
`trgt_tpu genotype --device host` from the same CRAM."""

import os
import random

import pytest
import torch

from trgt_tpu.cli import main as trgt_tpu_main
from trgt_tpu_torch.cli import main as port_main
from trgt_tpu_torch.io import native
from trgt_tpu_torch.io.bam import BamReader
from trgt_tpu_torch.io.cram import (ByteStream, CramReader, rans_decode,
                                    rans_decode_py)
from trgt_tpu_torch.io.cram_write import CramWriter, itf8, ltf8, rans_encode
from trgt_tpu_torch.utils.synth import (SynthLocus, adversarial_mutator,
                                        make_dataset)

from test_torch_genotype import records

torch.set_num_threads(1)


def test_itf8_ltf8_roundtrip():
    for v in (0, 1, 127, 128, 255, 16383, 16384, 1 << 20, 1 << 27,
              (1 << 31) - 1, -1, -2):
        assert ByteStream(itf8(v)).itf8() == v, v
    for v in (0, 127, 128, 1 << 14, 1 << 20, 1 << 35, 1 << 47,
              (1 << 63) - 1, 1 << 55, -1):
        assert ByteStream(ltf8(v)).ltf8() == v, v


@pytest.mark.parametrize("order", [0, 1])
def test_rans_roundtrip(order):
    rng = random.Random(11)
    cases = [b"", b"A", b"AAAAAAA",
             bytes(rng.choice(b"ACGT") for _ in range(1000)),
             bytes(rng.randrange(256) for _ in range(777)),
             bytes([7] * 4096),
             bytes(rng.choice(b"\x00\x01") for _ in range(63))]
    for data in cases:
        enc = rans_encode(data, order=order)
        assert rans_decode(enc) == data, (order, data[:20])
        assert rans_decode_py(enc) == data, (order, data[:20])
        if native.get_lib() is not None:
            assert native.rans_decode(enc) == data, (order, data[:20])


def bam_to_cram(bam_path, fasta, cram_path):
    """Writes the BAM's records to a CRAM with the port's writer; returns
    their number."""
    bam = BamReader(bam_path)
    writer = CramWriter(cram_path, bam.header.text, bam.header.references,
                        fasta)
    n = 0
    for rec in bam:
        aux = []
        for tag, val in rec.aux().items():
            if isinstance(val, float):
                aux.append((tag, "f", val))
            elif isinstance(val, int):
                aux.append((tag, "i", val))
            elif isinstance(val, tuple):
                aux.append((tag, "B", val))
            else:
                aux.append((tag, "Z", val))
        writer.write_record(rec.qname, rec.flag, rec.ref_id, rec.pos,
                            rec.mapq, rec.cigar, rec.seq, rec.qual, aux)
        n += 1
    writer.close()
    return n


def norm_cigar(cigar):
    """M, = and X as one M run: CRAM does not keep =/X."""
    out = []
    for length, op in cigar:
        op = "M" if op in "=X" else op
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + length, op)
        else:
            out.append((length, op))
    return out


@pytest.mark.parametrize("kind", ["meth", "errors", "adversarial"])
def test_cram_records_equal_bam(tmp_path, kind):
    """Every record read back from the port's CRAM equals its BAM record:
    MM/ML tags, substitutions, soft clips and indels included."""
    if kind == "meth":
        loci = [SynthLocus("C1", "CAG", 12, (12, 18)),
                SynthLocus("C2", "ATTCT", 8, (8, 30))]
        kw = dict(depth=10, meth_prob=200)
    elif kind == "errors":
        loci = [SynthLocus("E1", "CAG", 10, (8, 16))]
        kw = dict(depth=8, error_rate=0.03, seed=5)
    else:
        loci = [SynthLocus("A1", "CAG", 10, (8, 16)),
                SynthLocus("A2", "AT", 15, (15, 9))]
        kw = dict(depth=12, seed=3, read_mutator=adversarial_mutator)
    fasta, _bed, bam_path = make_dataset(str(tmp_path), loci, **kw)
    cram_path = str(tmp_path / "reads.cram")
    n = bam_to_cram(bam_path, fasta, cram_path)
    bam_recs = list(BamReader(bam_path))
    cram_recs = list(CramReader(cram_path, fasta))
    assert n > 0 and len(cram_recs) == n == len(bam_recs)
    for b, c in zip(bam_recs, cram_recs):
        assert (c.qname, c.flag, c.ref_id, c.pos, c.mapq, c.seq) == \
            (b.qname, b.flag, b.ref_id, b.pos, b.mapq, b.seq)
        assert bytes(c.qual) == bytes(b.qual)
        assert norm_cigar(c.cigar) == norm_cigar(b.cigar)
        assert c.aux() == b.aux()


def test_cram_fetch(tmp_path):
    loci = [SynthLocus("F1", "CAG", 10, (10, 14)),
            SynthLocus("F2", "CTG", 9, (9, 9))]
    fasta, bed, bam_path = make_dataset(str(tmp_path), loci, depth=6)
    cram_path = str(tmp_path / "reads.cram")
    bam_to_cram(bam_path, fasta, cram_path)
    assert os.path.exists(cram_path + ".crai")
    bam, cram = BamReader(bam_path), CramReader(cram_path, fasta)
    with open(bed) as fh:
        for line in fh:
            chrom, start, end, _ = line.split("\t")
            beg, fin = int(start) - 100, int(end) + 100
            names = sorted(r.qname for r in bam.fetch(chrom, beg, fin))
            assert names == sorted(r.qname
                                   for r in cram.fetch(chrom, beg, fin))
            assert names


def test_cram_corrupt_block_crc_raises(tmp_path):
    """A flipped byte inside a container surfaces as an error of the
    port's reader (block CRC32), never as silently wrong reads."""
    loci = [SynthLocus("CC", "CAG", 12, (12, 18))]
    fasta, _bed, bam_path = make_dataset(str(tmp_path), loci, depth=10)
    cram_path = str(tmp_path / "reads.cram")
    assert bam_to_cram(bam_path, fasta, cram_path) > 0
    clean = [(r.qname, r.seq) for r in CramReader(cram_path, fasta)]
    data = open(cram_path, "rb").read()
    saw_error = False
    for frac in (0.5, 0.6, 0.7, 0.8):
        corrupt = bytearray(data)
        corrupt[int(len(data) * frac)] ^= 0x41
        bad_path = str(tmp_path / f"bad_{frac}.cram")
        open(bad_path, "wb").write(bytes(corrupt))
        try:
            recs = list(CramReader(bad_path, fasta))
        except Exception:
            saw_error = True
            continue
        assert [(r.qname, r.seq) for r in recs] == clean
    assert saw_error


@pytest.fixture(scope="module")
def cram_dataset(tmp_path_factory):
    """Two loci with MM/ML tags and a third with adversarial read
    structure (reads rewritten with an all-M CIGAR), as BAM and as the
    port's CRAM of the same reads."""
    td = str(tmp_path_factory.mktemp("torch_cram"))
    loci = [SynthLocus("G1", "CAG", 12, (12, 20)),
            SynthLocus("G2", "CAGCCG", 6, (6, 9), motifs="CAG,CCG"),
            SynthLocus("G3", "AT", 15, (15, 11))]

    def mutator(rng, locus, seq, read_flank):
        if locus.id != "G3":
            return seq
        return adversarial_mutator(rng, locus, seq, read_flank)

    fasta, bed, bam = make_dataset(td, loci, depth=12, meth_prob=150,
                                   read_mutator=mutator)
    cram = os.path.join(td, "reads.cram")
    bam_to_cram(bam, fasta, cram)
    return td, fasta, bed, bam, cram


def genotype(main, dataset, reads, name, device):
    td, fasta, bed = dataset[:3]
    prefix = os.path.join(td, name)
    rc = main(["genotype", "--genome", fasta, "--repeats", bed, "--reads",
               reads, "--output-prefix", prefix, "--device", device])
    assert rc == 0
    return records(prefix)


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_genotype_cram_equals_bam_and_trgt_tpu(cram_dataset, device):
    """The port's `genotype` from the CRAM writes the VCF records of the
    same reads from the BAM, and the VCF and spanning-BAM records of
    `trgt_tpu --device host` from the same CRAM."""
    _td, _fasta, _bed, bam, cram = cram_dataset
    from_cram = genotype(port_main, cram_dataset, cram, f"cram_{device}",
                         device)
    from_bam = genotype(port_main, cram_dataset, bam, f"bam_{device}",
                        device)
    reference = genotype(trgt_tpu_main, cram_dataset, cram,
                         f"ref_cram_{device}", "host")
    body = [line for line in from_cram[0] if not line.startswith("#")]
    assert len(body) == 3 and all("\t./.:" not in line for line in body)
    assert from_cram[0] == from_bam[0]
    assert from_cram == reference
    assert len(from_cram[1]) > 0
