"""The benchmark's input generator: a synthetic genome, its repeat catalog
and a BAM of HiFi-like reads, all from `--seed`.

Its loci follow the program's own test generator (`utils/synth.py
hetero_loci`: motifs 1-10 bp, some loci with a decoy second motif, hom,
het and double-het genotypes), frozen here and extended:

- Compound loci: one locus in `compound_every` of the mix has two
  motifs that both occur, each allele a run of the first motif followed
  by a run of the second, so that the program's motif segmentation
  (MC, MS) has two runs to find.

- The catalog is built in blocks of loci, each block holding a fixed
  count of loci in each TR-length stratum of the traffic mix. The sizes
  in a block (TR lengths on a fixed quantile grid of their stratum,
  motifs, genotypes, depths) are the same for every seed; the seed
  shuffles them inside the block and draws the bases, the read placement
  and the read errors. So every seed hands the program the same work in
  another order.
- `genome` layout (whole-genome sequencing): loci a few kb apart on one
  contig, reads of HiFi length sampled over both haplotypes at the
  configured depth. A read covers several loci; its ends stay
  `end_guard` bases away from every TR, so a read either spans a locus
  with both flanks or does not reach it.
- `panel` layout (targeted sequencing): reads are fragments over one
  target each, the allele with a flank of a few hundred bases on each
  side; every second read carries a low `rq`, and some of those have an
  impure TR, which the program's impure-read filter has to drop.

Reads carry substitution errors only, so a read's TR has its allele's
length and the plain reference (reference.py) can rebuild each record.
"""

import math
import os

import numpy as np

from . import bamio

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
CONTIG = "chr1"
# golden-ratio sequence: deterministic, evenly spread fractions
PHI = (math.sqrt(5) - 1) / 2


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


class Locus:
    __slots__ = ("id", "motifs", "copies", "ref_copies", "copies2",
                 "depth", "error", "ref_start", "ref_end", "alleles")

    def __init__(self, lid, motifs, ref_copies, copies, copies2, depth,
                 error):
        self.id = lid
        self.motifs = motifs
        self.ref_copies = ref_copies
        self.copies = copies        # copies of motifs[0], one per allele
        self.copies2 = copies2      # copies of motifs[1] after them (0: none)
        self.depth = depth
        self.error = error
        self.ref_start = self.ref_end = 0
        self.alleles = None

    def tr(self, copies: int) -> bytes:
        """The TR of `copies` copies of the first motif and the locus's
        run of the second."""
        tr = self.motifs[0].encode() * copies
        if self.copies2:
            tr += self.motifs[1].encode() * self.copies2
        return tr

    def annotation(self, copies: int):
        """(MC, MS, AP) of the allele `tr(copies)`."""
        la = len(self.motifs[0]) * copies
        if self.copies2:
            lb = len(self.motifs[1]) * self.copies2
            return (f"{copies}_{self.copies2}",
                    f"0(0-{la})_1({la}-{la + lb})", "1.000000")
        mc = "_".join([str(copies)] + ["0"] * (len(self.motifs) - 1))
        return mc, f"0(0-{la})", "1.000000"


def catalog_spec(cfg: dict, mix: dict, seed: int):
    """The base catalog: `cfg["catalog_loci"]` loci in blocks of
    `mix["block"]`, shuffled inside each block by the seed."""
    block = mix["block"]
    n_blocks = cfg["catalog_loci"] // block
    motifs = mix["motifs"]
    rng = rng_for(seed, 1)
    out = []
    for b in range(n_blocks):
        specs = []
        for count, lo, hi in mix["strata"]:
            for j in range(count):
                # quantile grid of a log-uniform stratum, offset by block
                q = (j + (b * PHI) % 1.0) / count
                specs.append(int(lo * (hi / lo) ** q))
        rows = []
        for j, tr_len in enumerate(specs):
            k = b * block + j
            motif = motifs[k % len(motifs)]
            ref_copies = max(2, tr_len // len(motif))
            delta = max(1, ref_copies // 5)
            kind = k % 3
            copies = [(ref_copies, ref_copies),
                      (ref_copies, ref_copies + delta),
                      (max(2, ref_copies - delta), ref_copies + delta)][kind]
            names, copies2 = motif, 0
            if k % mix["decoy_every"] == 3:
                names += "," + motifs[(k + 4) % len(motifs)]
            elif mix.get("compound_every") and \
                    k % mix["compound_every"] == 5:
                second = motifs[(k + 3) % len(motifs)]
                names += "," + second
                copies2 = max(2, tr_len // (3 * len(second)))
            depth = None
            for cap, lo_d, hi_d in cfg.get("depth_by_tr_len", []):
                if cap is None or tr_len <= cap:
                    depth = lo_d + int((hi_d - lo_d) * ((k * PHI) % 1.0))
                    break
            errors = cfg.get("locus_error")
            error = errors[k % len(errors)] if errors else None
            rows.append((names, ref_copies, copies, copies2, depth, error))
        for j in rng.permutation(len(rows)):
            names, ref_copies, copies, copies2, depth, error = rows[j]
            out.append(Locus(f"TR{len(out)}", names.split(","), ref_copies,
                             copies, copies2, depth, error))
    return out


class Dataset:
    """Everything the generator made, in memory: the reference, the two
    haplotypes, the loci with their coordinates and the reads with their
    errors. The plain reference reads the records it expects from it."""

    def __init__(self, cfg, mix, seed):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.loci = catalog_spec(cfg, mix, seed)
        rng = rng_for(seed, 2)
        n = len(self.loci)
        gap_lo, gap_hi = cfg["locus_gap"]
        gaps = rng.integers(gap_lo, gap_hi + 1, size=n + 1)
        ref_tr = [lc.tr(lc.ref_copies) for lc in self.loci]
        ref_len = np.array([len(t) for t in ref_tr], dtype=np.int64)
        total = int(gaps.sum() + ref_len.sum())
        self.ref = ACGT[rng.integers(0, 4, size=total)]
        pos = 0
        for i, lc in enumerate(self.loci):
            pos += int(gaps[i])
            lc.ref_start, lc.ref_end = pos, pos + len(ref_tr[i])
            self.ref[pos:lc.ref_end] = np.frombuffer(ref_tr[i], np.uint8)
            pos = lc.ref_end
            lc.alleles = [lc.tr(lc.copies[0]), lc.tr(lc.copies[1])]
        # haplotypes: the reference with each TR replaced by its allele
        self.haps, self.hap_tr, self.hap_off = [], [], []
        for h in range(2):
            parts, tr, off = [], [], [0]
            prev = 0
            hpos = 0
            for lc in self.loci:
                parts.append(self.ref[prev:lc.ref_start])
                hpos += lc.ref_start - prev
                a = np.frombuffer(lc.alleles[h], np.uint8)
                parts.append(a)
                tr.append((hpos, hpos + len(a)))
                hpos += len(a)
                off.append(off[-1] + len(a) - (lc.ref_end - lc.ref_start))
                prev = lc.ref_end
            parts.append(self.ref[prev:])
            self.haps.append(np.concatenate(parts))
            self.hap_tr.append(np.array(tr, dtype=np.int64))
            self.hap_off.append(np.array(off, dtype=np.int64))
        if cfg["layout"] == "genome":
            self._genome_reads(rng_for(seed, 3))
        else:
            self._panel_reads(rng_for(seed, 3))

    # ---- reads ----
    def _genome_reads(self, rng):
        cfg = self.cfg
        guard = cfg["end_guard"]
        lo, hi = cfg["read_len"]
        hs, he, hh = [], [], []
        for h in range(2):
            tr = self.hap_tr[h]
            hap_len = len(self.haps[h])
            # zones where a read may start or end: gap interiors
            z0 = np.concatenate([[0], tr[:, 1] + guard])
            z1 = np.concatenate([tr[:, 0] - guard, [hap_len]])
            n = int(round(cfg["depth"] / 2 * hap_len / ((lo + hi) / 2)))
            s = rng.integers(0, hap_len, size=n)
            ln = rng.integers(lo, hi + 1, size=n)
            zi = np.searchsorted(z0, s, side="right") - 1
            out = s > z1[zi]
            zi = zi + out
            ok = zi < len(z0)
            zi = np.minimum(zi, len(z0) - 1)
            s = np.where(out, z0[zi], s)
            e = s + ln
            ze = np.searchsorted(z0, e, side="right") - 1
            e = np.minimum(e, z1[ze])
            ok &= e - s >= lo // 2
            hs.append(s[ok])
            he.append(e[ok])
            hh.append(np.full(ok.sum(), h, dtype=np.int8))
        self.r_hap = np.concatenate(hh)
        self.r_start = np.concatenate(hs).astype(np.int64)
        self.r_end = np.concatenate(he).astype(np.int64)
        m = len(self.r_hap)
        low = rng.random(m) < cfg["low_rq_share"]
        err = rng.uniform(*cfg["read_error"], size=m)
        rq = 1.0 - err
        rq[low] = rng.uniform(*cfg["low_rq"], size=int(low.sum()))
        err[low] = cfg["low_rq_error"]
        self.r_rq = rq.astype(np.float32)
        self.r_impure = np.zeros(m, dtype=bool)
        self._errors(rng, err, None)

    def _panel_reads(self, rng):
        cfg = self.cfg
        lo, hi = cfg["read_flank"]
        hs, he, hh, rq, err, imp_lo, imp_hi = [], [], [], [], [], [], []
        for i, lc in enumerate(self.loci):
            d = lc.depth
            h = np.arange(d) % 2
            s = self.hap_tr[0][i, 0] * (h == 0) + self.hap_tr[1][i, 0] * (h == 1)
            e = self.hap_tr[0][i, 1] * (h == 0) + self.hap_tr[1][i, 1] * (h == 1)
            hs.append(s - rng.integers(lo, hi + 1, size=d))
            he.append(e + rng.integers(lo, hi + 1, size=d))
            hh.append(h.astype(np.int8))
            q = np.where(np.arange(d) % 2 == 1, cfg["low_rq"], 0.999)
            rq.append(q)
            err.append(np.full(d, lc.error))
            # impure TRs: one low-rq read in every `impure_every` reads
            lowq = np.flatnonzero(q < 0.9)
            pick = np.zeros(d, dtype=bool)
            pick[rng.permutation(lowq)[:d // cfg["impure_every"]]] = True
            imp_lo.append(np.where(pick, s, 0))
            imp_hi.append(np.where(pick, e, 0))
        self.r_hap = np.concatenate(hh)
        self.r_start = np.concatenate(hs).astype(np.int64)
        self.r_end = np.concatenate(he).astype(np.int64)
        self.r_rq = np.concatenate(rq).astype(np.float32)
        lo_i, hi_i = np.concatenate(imp_lo), np.concatenate(imp_hi)
        self.r_impure = hi_i > 0
        self._errors(rng, np.concatenate(err), (lo_i, hi_i))

    def _errors(self, rng, rate, impure):
        """Substitutions at `rate` a base over each read, and at
        `impure_error` over the TR of each impure read; stored sparsely,
        in haplotype coordinates, sorted by read."""
        lens = self.r_end - self.r_start
        k = rng.binomial(lens, rate)
        read = np.repeat(np.arange(len(lens)), k)
        pos = self.r_start[read] + (rng.random(len(read)) * lens[read]).astype(np.int64)
        if impure is not None:
            lo_i, hi_i = impure
            tl = (hi_i - lo_i)[self.r_impure]
            ki = rng.binomial(tl, self.cfg["impure_error"])
            ids = np.flatnonzero(self.r_impure)
            r2 = np.repeat(ids, ki)
            p2 = lo_i[r2] + (rng.random(len(r2)) * (hi_i - lo_i)[r2]).astype(np.int64)
            read = np.concatenate([read, r2])
            pos = np.concatenate([pos, p2])
        order = np.lexsort((pos, read))
        self.e_read, self.e_pos = read[order], pos[order]
        self.e_shift = rng.integers(1, 4, size=len(order)).astype(np.uint8)
        self.e_ptr = np.searchsorted(self.e_read, np.arange(len(lens) + 1))

    def read_seq(self, r: int) -> np.ndarray:
        """Bases of read r (ASCII codes), errors applied."""
        s = self.r_start[r]
        seq = self.haps[self.r_hap[r]][s:self.r_end[r]].copy()
        a, b = self.e_ptr[r], self.e_ptr[r + 1]
        idx = self.e_pos[a:b] - s
        code = np.searchsorted(ACGT, seq[idx])
        seq[idx] = ACGT[(code + self.e_shift[a:b]) % 4]
        return seq

    def read_name(self, r: int) -> str:
        return f"m{r}"

    def reads_over(self, i: int) -> np.ndarray:
        """Reads that span locus i, both flanks included."""
        ts = np.where(self.r_hap == 0, self.hap_tr[0][i, 0], self.hap_tr[1][i, 0])
        te = np.where(self.r_hap == 0, self.hap_tr[0][i, 1], self.hap_tr[1][i, 1])
        return np.flatnonzero((self.r_start <= ts) & (self.r_end >= te))

    def tr_in_read(self, r: int, i: int):
        ts, te = self.hap_tr[self.r_hap[r]][i]
        return int(ts - self.r_start[r]), int(te - self.r_start[r])

    # ---- files ----
    def _alignment(self, r: int):
        """(reference position, CIGAR, reference end) of read r."""
        h = self.r_hap[r]
        s, e = int(self.r_start[r]), int(self.r_end[r])
        tr = self.hap_tr[h]
        first = int(np.searchsorted(tr[:, 0], s))
        last = int(np.searchsorted(tr[:, 0], e))
        pos = s - int(self.hap_off[h][first])
        cigar, cur, ref_span, m = [], s, 0, 0
        for i in range(first, last):
            a0, a1 = int(tr[i, 0]), int(tr[i, 1])
            lc = self.loci[i]
            la, lr = a1 - a0, lc.ref_end - lc.ref_start
            m += a0 - cur + min(la, lr)
            ref_span += a0 - cur + lr
            if la != lr:
                cigar.append((m, "M"))
                cigar.append((la - lr, "I") if la > lr else (lr - la, "D"))
                m = 0
            cur = a1
        m += e - cur
        ref_span += e - cur
        cigar.append((m, "M"))
        return pos, cigar, pos + ref_span

    def write(self, out_dir: str, catalog_lines: int) -> dict:
        """FASTA, BED (the base catalog repeated up to `catalog_lines`
        lines) and BAM into `out_dir`; their paths."""
        fasta = os.path.join(out_dir, "ref.fasta")
        bed = os.path.join(out_dir, "repeats.bed")
        bam = os.path.join(out_dir, "reads.bam")
        bamio.write_fasta(fasta, CONTIG, self.ref)
        lines = [f"{CONTIG}\t{lc.ref_start}\t{lc.ref_end}\tID={lc.id};"
                 f"MOTIFS={','.join(lc.motifs)};STRUC=<TR>\n"
                 for lc in self.loci]
        reps = -(-catalog_lines // len(lines))
        with open(bed, "w") as fh:
            fh.write("".join(lines) * reps)
        recs = []
        for r in range(len(self.r_hap)):
            pos, cigar, end = self._alignment(r)
            recs.append((pos, end, r, cigar))
        recs.sort(key=lambda t: (t[0], t[2]))
        qual = self.cfg["base_qual"]
        encoded = [(pos, end, bamio.encode_record(
                        self.read_name(r), pos, cigar, self.read_seq(r),
                        qual, float(self.r_rq[r])))
                   for pos, end, r, cigar in recs]
        bamio.write_bam(bam, CONTIG, len(self.ref), encoded)
        return {"genome": fasta, "repeats": bed, "reads": bam}
