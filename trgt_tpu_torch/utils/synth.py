"""Synthetic dataset generator: builds a reference FASTA (+.fai), repeat
catalog BED, and a sorted+indexed BAM of reads over chosen genotypes.
Used by the e2e tests AND the multi-chip production dry run
(engine/sharding.py), so the dry run exercises the same input stack the
real `genotype` command uses."""

import random
from typing import List, Optional, Tuple

from ..io.bam_write import BamWriter


class SynthLocus:
    def __init__(self, lid: str, motif: str, ref_copies: int,
                 allele_copies: Tuple[int, int], motifs: Optional[str] = None,
                 depth: Optional[int] = None,
                 error_rate: Optional[float] = None):
        self.id = lid
        self.motif = motif
        self.ref_copies = ref_copies
        self.allele_copies = allele_copies
        self.motifs = motifs or motif
        # per-locus overrides of the dataset-level values (heterogeneous
        # catalogs; None keeps the make_dataset defaults)
        self.depth = depth
        self.error_rate = error_rate


def mm_ml_for(seq: str, prob: int):
    """MM/ML aux tags marking every CpG cytosine as modified with the
    given probability (forward-strand read)."""
    c_positions = [i for i, ch in enumerate(seq) if ch == "C"]
    cpg_cs = [i for i in c_positions
              if i + 1 < len(seq) and seq[i + 1] == "G"]
    deltas = []
    prev_rank = -1
    rank_of = {pos: r for r, pos in enumerate(c_positions)}
    for pos in cpg_cs:
        r = rank_of[pos]
        deltas.append(r - prev_rank - 1)
        prev_rank = r
    if not deltas:
        return None
    mm = "C+m," + ",".join(str(d) for d in deltas) + ";"
    ml = [prob] * len(deltas)
    return [("MM", "Z", mm), ("ML", "B", ("C", ml))]


def cached_hetero_dataset(n: int, seed: int = 42, chrom: str = "chrS",
                          haploid_homs: bool = False, root: str = None,
                          tag: str = "hetero") -> str:
    """Generate (or reuse) the deterministic heterogeneous dataset under
    a cache dir; writes ref.fasta/repeats.bed/reads.bam + truth.json
    (expected allele TR lengths per locus). Callers that pass the same
    root share the files."""
    import json
    import os
    import tempfile
    root = root or os.environ.get(
        "TRGT_SYNTH_CACHE",
        os.path.join(tempfile.gettempdir(), "trgt_hetero_cache"))
    d = os.path.join(root, f"{tag}_n{n}_s{seed}")
    marker = os.path.join(d, "DONE")
    if os.path.exists(marker):
        return d
    os.makedirs(d, exist_ok=True)
    loci = hetero_loci(n, seed=seed)
    if haploid_homs:
        # haploid truth needs a single well-defined allele
        for lc in loci:
            lc.allele_copies = (lc.allele_copies[0], lc.allele_copies[0])
    make_dataset(d, loci, seed=seed, chrom=chrom)
    truth = {}
    for lc in loci:
        truth[lc.id] = {
            "motif_len": len(lc.motif),
            "alleles": sorted(a * len(lc.motif) for a in lc.allele_copies),
            "error_rate": lc.error_rate or 0.0,
            "haploid": haploid_homs,
        }
    with open(os.path.join(d, "truth.json"), "w") as fh:
        json.dump(truth, fh)
    with open(marker, "w") as fh:
        fh.write("ok\n")
    return d


def adversarial_mutator(rng, locus, seq: str, read_flank: int) -> str:
    """Adversarial read structure (diversify
    inputs beyond clean synthetics): motif-copy stutter inside the TR
    (slippage), small indels within 20bp of the TR boundary (the flank
    piece's hardest region for the span certificate), and scattered
    substitutions. Truth-AL is not asserted on these loci — the
    assertions are device==host bytes and pipeline robustness."""
    motif = locus.motif
    tr_start = read_flank
    tr_end = len(seq) - read_flank
    s = list(seq)
    # stutter: insert or delete 1-3 motif copies mid-TR
    if rng.random() < 0.5 and tr_end - tr_start >= 2 * len(motif):
        k = rng.randint(1, 3)
        pos = rng.randrange(tr_start, tr_end - len(motif))
        if rng.random() < 0.5:
            s[pos:pos] = list(motif * k)
        else:
            del s[pos:pos + len(motif) * min(k, 1)]
    # boundary indels: 1-5bp within 20bp of a TR boundary
    if rng.random() < 0.6:
        side = rng.choice([tr_start, tr_end])
        pos = max(0, min(len(s) - 6, side + rng.randint(-20, 20)))
        n = rng.randint(1, 5)
        if rng.random() < 0.5:
            s[pos:pos] = [rng.choice("ACGT") for _ in range(n)]
        else:
            del s[pos:pos + n]
    # scattered substitutions ~1%
    for i in range(len(s)):
        if rng.random() < 0.01:
            s[i] = rng.choice("ACGT".replace(s[i], ""))
    return "".join(s)


# adversarial motif pool: homopolymers and low-complexity motifs whose
# flank-adjacent slippage stresses the span seeds/certificate hardest
ADVERSARIAL_MOTIFS = ["A", "T", "AT", "AAT", "CAG", "AAAG", "ATTCT"]


def adversarial_loci(n: int, seed: int = 7) -> List[SynthLocus]:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        motif = ADVERSARIAL_MOTIFS[i % len(ADVERSARIAL_MOTIFS)]
        mlen = len(motif)
        tr_len = int(20.0 * (100.0 ** rng.random()))       # 20..2000 bp
        ref_copies = max(2, tr_len // mlen)
        delta = max(1, ref_copies // 4)
        alleles = [(ref_copies, ref_copies),
                   (ref_copies, ref_copies + delta),
                   (max(2, ref_copies - delta), ref_copies + delta)][i % 3]
        out.append(SynthLocus(f"ADV{i}", motif, ref_copies, alleles,
                              depth=rng.randint(10, 40),
                              error_rate=0.01))
    return out


# motif pool covering lengths 1-10 (heterogeneous HMM topologies)
HETERO_MOTIFS = ["T", "TG", "CAG", "GATA", "AATGG", "CCATGG", "CCATAGG",
                 "CCATTAGG", "CCATTTAGG", "CCATTTTAGG"]


def hetero_loci(n: int, seed: int = 42) -> List[SynthLocus]:
    """Deterministic heterogeneous catalog spec:
    motif lengths 1-10, TR lengths ~10bp-10kb (log-uniform), per-locus
    depths 10-200 (capped for long TRs to bound data volume), error
    rates 0-2%, hom/het/double-het genotypes, some multi-motif
    definitions. Truth for error-free loci: allele TR lengths =
    copies × motif_len."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        motif = HETERO_MOTIFS[i % len(HETERO_MOTIFS)]
        mlen = len(motif)
        tr_len = int(10.0 * (1000.0 ** rng.random()))      # 10..10000 bp
        ref_copies = max(2, tr_len // mlen)
        if tr_len <= 500:
            depth = rng.randint(10, 200)
        elif tr_len <= 2000:
            depth = rng.randint(10, 60)
        else:
            depth = rng.randint(8, 20)
        kind = i % 3
        delta = max(1, ref_copies // 5)
        if kind == 0:
            alleles = (ref_copies, ref_copies)             # hom ref
        elif kind == 1:
            alleles = (ref_copies, ref_copies + delta)     # het expansion
        else:
            alleles = (max(2, ref_copies - delta),
                       ref_copies + delta)                 # double het
        error_rate = [0.0, 0.0, 0.005, 0.01, 0.02][i % 5]
        motifs = motif
        if i % 7 == 3:
            # decoy second motif → multi-motif HMM in the same batch
            motifs = motif + "," + HETERO_MOTIFS[(i + 4) % len(HETERO_MOTIFS)]
        out.append(SynthLocus(f"HET{i}", motif, ref_copies, alleles,
                              motifs=motifs, depth=depth,
                              error_rate=error_rate))
    return out


def make_dataset(tmpdir: str, loci: List[SynthLocus], depth: int = 20,
                 flank: int = 400, read_flank: int = 300,
                 seed: int = 0, chrom: str = "chrS", meth_prob=None,
                 error_rate: float = 0.0, read_mutator=None):
    """`read_mutator(rng, locus, seq, read_flank) -> seq` lets callers
    inject adversarial read structure (stutter, boundary indels);
    mutated reads carry an all-M CIGAR like error reads."""
    rng = random.Random(seed)

    ref_parts = []
    catalog = []
    pos = 0
    locus_layout = []
    for locus in loci:
        left = "".join(rng.choice("ACGT") for _ in range(flank))
        tr_ref = locus.motif * locus.ref_copies
        pos += len(left)
        start = pos
        pos += len(tr_ref)
        end = pos
        locus_layout.append((locus, start, end))
        catalog.append(f"{chrom}\t{start}\t{end}\t"
                       f"ID={locus.id};MOTIFS={locus.motifs};STRUC=<TR>")
        ref_parts.append(left + tr_ref)
    tail = "".join(rng.choice("ACGT") for _ in range(flank))
    ref_parts.append(tail)
    ref_seq = "".join(ref_parts)

    fasta_path = f"{tmpdir}/ref.fasta"
    with open(fasta_path, "w") as fh:
        fh.write(f">{chrom}\n")
        for i in range(0, len(ref_seq), 60):
            fh.write(ref_seq[i:i + 60] + "\n")
    with open(fasta_path + ".fai", "w") as fh:
        fh.write(f"{chrom}\t{len(ref_seq)}\t{len(chrom) + 2}\t60\t61\n")

    bed_path = f"{tmpdir}/repeats.bed"
    with open(bed_path, "w") as fh:
        fh.write("\n".join(catalog) + "\n")

    # reads: per locus, half the depth per allele, perfect sequences
    records = []
    for locus, start, end in locus_layout:
        lf = ref_seq[start - read_flank:start]
        rf = ref_seq[end:end + read_flank]
        locus_depth = locus.depth if locus.depth is not None else depth
        locus_err = (locus.error_rate if locus.error_rate is not None
                     else error_rate)
        for ri in range(locus_depth):
            allele = locus.allele_copies[ri % 2]
            tr = locus.motif * allele
            seq = lf + tr + rf
            ref_copies = locus.ref_copies
            # CIGAR vs the reference: flank matches, TR indel
            motif_len = len(locus.motif)
            delta = (allele - ref_copies) * motif_len
            cigar = [(read_flank, "=")]
            if delta == 0:
                cigar.append((len(tr), "="))
            elif delta > 0:
                common = ref_copies * motif_len
                cigar.append((common, "="))
                cigar.append((delta, "I"))
            else:
                common = allele * motif_len
                cigar.append((common, "="))
                cigar.append((-delta, "D"))
            cigar.append((read_flank, "="))
            pos0 = start - read_flank
            if locus_err > 0.0:
                mutated = []
                for ch in seq:
                    if rng.random() < locus_err:
                        mutated.append(rng.choice("ACGT".replace(ch, "")))
                    else:
                        mutated.append(ch)
                seq = "".join(mutated)
                cigar = [(len(seq), "M")]
            if read_mutator is not None:
                new_seq = read_mutator(rng, locus, seq, read_flank)
                if new_seq != seq:
                    seq = new_seq
                    cigar = [(len(seq), "M")]
            records.append((pos0, f"{locus.id}_read{ri}", seq, cigar))

    records.sort(key=lambda r: r[0])
    bam_path = f"{tmpdir}/reads.bam"
    header_text = (f"@HD\tVN:1.5\tSO:coordinate\n"
                   f"@SQ\tSN:{chrom}\tLN:{len(ref_seq)}\n"
                   f"@RG\tID:rg1\tSM:synth\n")
    writer = BamWriter(bam_path, header_text, [(chrom, len(ref_seq))],
                       build_index=True)
    for pos0, name, seq, cigar in records:
        aux = [("rq", "f", 0.999)]
        if meth_prob is not None:
            tags = mm_ml_for(seq, meth_prob)
            if tags:
                aux.extend(tags)
        writer.write_record(name, 0, 0, pos0, 60, cigar, seq,
                            bytes([40] * len(seq)), aux)
    writer.close()
    return fasta_path, bed_path, bam_path
