"""The plain reference: the record each locus should get, worked out again
from the generator's reads with NumPy, and the comparison that decides a
run's `correct`. It imports nothing of the program.

For a locus, from the reads that span it (synth.Dataset.reads_over):

- spans: the reads that pass the configuration's gates. `--preset wgs`
  drops reads under `min_read_qual`; `--preset targeted` labels every
  read under rq 0.9 and drops, up to max(1, round(n / 10)) of the n
  spanning reads, those whose TR purity is under 0.9, lowest first.
  Purity here is the share of TR bases equal to the allele the read
  was drawn from (reads carry substitutions only), pure or compound.
  The program measures purity on its own Viterbi path, so reads whose
  purity lies within `PURITY_BAND` of the cutoff, or within `RANK_BAND`
  of the cap's edge where the cap binds, may go either way. Each kept read
  is written clipped to its TR and `output_flank_len` (50) bases on
  each side. The TR's ends in a read are where the program's flank
  alignment puts them: a read error next to an end can move it by a few
  bases, so a read's clipped bases may start and end up to `END_SHIFT`
  bases off the generator's TR ends.
- genotype: the kept reads grouped by TR length (substitutions keep
  lengths). Which groups are called: under `--preset wgs` TRGT's size
  genotyper (diploid.rs: the pair of lengths of least penalty, a read
  costing 0 at its own length and 10 + 2 x the difference elsewhere,
  the farther allele of a pair weighted 0.25, or 0.05 where the pair's
  two lengths lie over 100 bases apart;
  a pair within 6 bases whose top length holds over 60 % of the reads
  is called homozygous); under `--preset targeted` the cluster
  genotyper (genotype_cluster.rs: the two length groups, or the larger
  one twice where they differ by under 100 bases and one holds over
  four times the other's reads). Each allele is the column-wise
  majority of its group, and where a column ties, every tied base is
  accepted.
- annotate: an allele equal to one of the locus's true alleles has the
  MC, MS and AP of that allele: the copies of each motif (0 for a
  decoy that does not occur), one span a motif run, purity 1. Alleles
  that equal neither are not judged here.

Numbers compared, over the sampled loci (limits in each configuration
file's `limits`):
  span_reads_off     reads written but not expected, expected but not
                     written, or written with other bases than its own
                     around the TR
  genotype_off       loci whose called allele lengths, as a multiset,
                     differ from the reference's call
  allele_bases_off   the widest count of an allele's bases outside the
                     reference's majority, over the alleles of a group's
                     length
  annotation_off     alleles whose MC, MS or AP differ
"""

import numpy as np

OUTPUT_FLANK = 50
PURITY_CUTOFF = 0.9
LOW_RQ = 0.9
PURITY_BAND = 0.05
# the program ranks reads by purity on its Viterbi path, which lies up
# to 0.14 from the share of bases equal to the read's allele on a read
# with 30 % substitutions: reads this close to the cap's edge may fall
# on either side of it
RANK_BAND = 0.15
END_SHIFT = 5


class Record:
    """What a locus's record says, as judged here."""

    def __init__(self, alleles, mc, ms, ap, spans):
        self.alleles = alleles      # allele sequences (bytes), GT order
        self.mc, self.ms, self.ap = mc, ms, ap
        self.spans = spans          # read name -> clipped bases


def parse_vcf_line(line: bytes):
    """(TRID, Record without spans) of one VCF line; None for a record
    without a genotype."""
    f = line.rstrip(b"\n").split(b"\t")
    info = dict(kv.split(b"=", 1) for kv in f[7].split(b";"))
    trid = info[b"TRID"].decode()
    vals = dict(zip(f[8].split(b":"), f[9].split(b":")))
    gt = vals[b"GT"]
    if b"." in gt:
        return trid, None
    seqs = [f[3][1:]] + [a[1:] for a in f[4].split(b",") if a != b"."]
    alleles = [seqs[int(g)] for g in gt.split(b"/")]
    split = lambda k: vals[k].decode().split(",")
    return trid, Record(alleles, split(b"MC"), split(b"MS"), split(b"AP"), {})


def _purity(seq: np.ndarray, allele: bytes) -> float:
    """Share of a read's TR bases equal to the allele it was drawn from."""
    if not len(seq):
        return 1.0
    return float((seq == np.frombuffer(allele, np.uint8)).mean())


def size_call(lengths, counts):
    """The two allele lengths TRGT's size genotyper calls from reads of
    `lengths` with `counts` reads each (diploid.rs)."""
    def cost(allele, read):
        return 0 if allele == read else 10 + 2 * abs(allele - read)
    best = None
    for a, short in enumerate(lengths):
        for long in lengths[a:]:
            frac = 0.05 if long - short > 100 else 0.25
            pen = 0.0
            for read, n in zip(lengths, counts):
                lo, hi = sorted((cost(short, read), cost(long, read)))
                pen += n * (lo + frac * hi)
            if best is None or pen < best[0]:
                best = (pen, short, long)
    _, short, long = best
    top = max(range(len(lengths)), key=lambda k: (counts[k], -k))
    if short != long and counts[top] / sum(counts) > 0.60 and \
            max(lengths) - min(lengths) <= 6:
        short = long = lengths[top]
    return sorted((short, long))


def cluster_call(lengths, counts):
    """The two allele lengths TRGT's cluster genotyper calls where the
    reads fall into length groups (genotype_cluster.rs)."""
    if len(lengths) == 1:
        return [lengths[0]] * 2
    order = sorted(range(len(lengths)), key=lambda k: counts[k])
    big, small = order[-1], order[-2]
    if abs(lengths[big] - lengths[small]) < 100 and \
            counts[small] * 4 < counts[big]:
        return [lengths[big]] * 2
    return sorted((lengths[big], lengths[small]))


def expected(ds, i: int, params: dict, control: bool = False):
    """(spans {name: (read bases, clip start, clip end)}, names that may
    go either way, allele groups {length: [(4, length) base counts, one
    read's bases, its TR start, its TR end]}) of locus i; with `control`, the
    gates that the configuration's control breaks are off."""
    lc = ds.loci[i]
    gates = not (control and ds.cfg["control"]["gates_off"])
    reads = ds.reads_over(i)
    if gates:
        reads = reads[ds.r_rq[reads] >= params["min_read_qual"]]
    seqs, trs = {}, {}
    for r in reads:
        seqs[r] = ds.read_seq(r)
        trs[r] = ds.tr_in_read(r, i)
    either = set()
    drop = set()
    if gates and params["min_read_qual"] < LOW_RQ:
        pur = {r: _purity(seqs[r][trs[r][0]:trs[r][1]],
                          lc.alleles[ds.r_hap[r]])
               for r in reads if ds.r_rq[r] < LOW_RQ}
        cap = max(1, round(0.1 * len(reads)))
        cand = sorted((p, r) for r, p in pur.items()
                      if p < PURITY_CUTOFF + PURITY_BAND)
        # purity of the first read past the cap, and of the last within it
        past = cand[cap][0] if len(cand) > cap else None
        last = cand[min(cap, len(cand)) - 1][0] if cand else None
        for rank, (p, r) in enumerate(cand):
            if p >= PURITY_CUTOFF - PURITY_BAND:
                either.add(ds.read_name(r))
            elif rank < cap:
                if past is not None and past - p < RANK_BAND:
                    either.add(ds.read_name(r))
                else:
                    drop.add(r)
            elif p - last < RANK_BAND:
                either.add(ds.read_name(r))
    spans, groups = {}, {}
    for r in reads:
        if r in drop:
            continue
        t0, t1 = trs[r]
        s = seqs[r]
        spans[ds.read_name(r)] = (s, t0 - OUTPUT_FLANK, t1 + OUTPUT_FLANK)
        if ds.read_name(r) in either:
            continue
        tr = s[t0:t1]
        onehot = (tr[None, :] == np.frombuffer(b"ACGT", np.uint8)[:, None])
        if len(tr) in groups:
            groups[len(tr)][0] += onehot
        else:
            groups[len(tr)] = [onehot.astype(np.int32), s, t0, t1]
    return spans, either, groups


def _clipped_from(exp, got) -> bool:
    """Whether `got` is the read's bases from the expected clip start to
    the expected clip end, each end within END_SHIFT bases."""
    if exp is None or got is None:
        return False
    seq, a, b = exp
    lo = max(0, a - END_SHIFT)
    at = seq.tobytes().find(got, lo, b + END_SHIFT + 1)
    return 0 <= at - lo <= a - lo + END_SHIFT and \
        abs(at + len(got) - b) <= END_SHIFT


def true_annotation(allele: bytes, lc):
    """(MC, MS, AP) of an allele equal to one of locus `lc`'s true
    alleles, or None where it equals neither."""
    for h in (0, 1):
        if allele == lc.alleles[h]:
            return lc.annotation(lc.copies[h])
    return None


def called_lengths(groups, genotyper: str):
    """The reference's call: the two allele lengths, sorted."""
    lengths = sorted(groups)
    if not lengths:
        return []
    counts = [int(groups[n][0][:, 0].sum()) for n in lengths]
    if genotyper == "size":
        return size_call(lengths, counts)
    return cluster_call(lengths, counts)


def control_record(ds, i: int, params: dict) -> Record:
    """The reference put in the program's place, with the guarantee that
    the configuration's control breaks broken: its gates off and each
    allele taken from one read of its group, not from their consensus."""
    spans, _, groups = expected(ds, i, params, control=True)
    spans = {n: s[a:b].tobytes() for n, (s, a, b) in spans.items()}
    alleles = []
    for length in called_lengths(groups, params["genotyper"]):
        _, s, t0, t1 = groups[length]
        alleles.append(s[t0:t1].tobytes())
    mc, ms, ap = [], [], []
    for a in alleles:
        ann = true_annotation(a, ds.loci[i]) or \
            ("0", f"0(0-{len(a)})", "0.000000")
        mc.append(ann[0]), ms.append(ann[1]), ap.append(ann[2])
    return Record(alleles, mc, ms, ap, spans)


def judge(ds, i: int, rec: Record, params: dict) -> dict:
    """The numbers of one locus: its record against the reference's."""
    spans, either, groups = expected(ds, i, params)
    names = set(spans) | set(rec.spans)
    span_off = sum(1 for n in names - either
                   if not _clipped_from(spans.get(n), rec.spans.get(n)))
    genotype_off = int(sorted(len(a) for a in rec.alleles)
                       != called_lengths(groups, params["genotyper"]))
    allele_off = 0
    majority = {}
    for length, (counts, *_rest) in groups.items():
        majority[length] = counts == counts.max(axis=0, keepdims=True)
    for a in rec.alleles:
        ok = majority.get(len(a))
        if ok is None:
            continue              # a length of no group: genotype_off
        codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                                np.frombuffer(a, np.uint8))
        codes = np.minimum(codes, 3)
        hit = ok[codes, np.arange(len(a))] & \
            (np.frombuffer(b"ACGT", np.uint8)[codes] == np.frombuffer(a, np.uint8))
        allele_off = max(allele_off, int((~hit).sum()))
    ann_off = unjudged = 0
    for k, a in enumerate(rec.alleles):
        ann = true_annotation(a, ds.loci[i])
        if ann is None:
            unjudged += 1
        elif (rec.mc[k], rec.ms[k], rec.ap[k]) != ann:
            ann_off += 1
    return {"span_reads_off": span_off, "genotype_off": genotype_off,
            "allele_bases_off": allele_off, "annotation_off": ann_off,
            "alleles_unjudged": unjudged}


def fold(per_locus) -> dict:
    """The run's numbers from its loci's: counts add, the widest gap is a
    maximum."""
    out = {"span_reads_off": 0, "genotype_off": 0, "allele_bases_off": 0,
           "annotation_off": 0, "alleles_unjudged": 0, "loci_checked": 0}
    for d in per_locus:
        out["loci_checked"] += 1
        for k in ("span_reads_off", "genotype_off", "annotation_off",
                  "alleles_unjudged"):
            out[k] += d[k]
        out["allele_bases_off"] = max(out["allele_bases_off"],
                                      d["allele_bases_off"])
    return out
