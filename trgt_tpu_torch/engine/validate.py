"""`validate` command (ref: src/commands/validate.rs)."""

import math
import sys

from ..io.catalog import iter_loci
from ..io.fasta import FastaReader
from ..utils import Genotyper, Karyotype


def format_number_with_commas(n: int) -> str:
    # ref: src/utils/util.rs format_number_with_commas
    return f"{n:,}"


def _stats(data):
    s = sorted(data)
    n = len(s)
    if n == 0:
        return dict(min=0, max=0, mean=0.0, median=0.0, std_dev=0.0)
    median = (s[n // 2 - 1] + s[n // 2]) / 2.0 if n % 2 == 0 else float(
        s[n // 2])
    mean = sum(s) / n
    std = math.sqrt(sum((x - mean) ** 2 for x in s) / n)
    return dict(min=s[0], max=s[-1], mean=mean, median=median, std_dev=std)


def run_validate(args) -> None:
    genome = FastaReader(args.genome_path)
    error_count = 0
    success_count = 0
    motifs_lengths = []
    tr_lengths = []

    def on_error(msg):
        nonlocal error_count
        print(msg, file=sys.stderr)
        error_count += 1

    for locus in iter_loci(args.repeats_path, genome, Karyotype.new("XY"),
                           args.flank_len, Genotyper.SIZE,
                           on_error=on_error):
        motifs_lengths.append(len(locus.motifs))
        tr_lengths.append(len(locus.tr))
        success_count += 1

    motifs_stats = _stats(motifs_lengths)
    tr_stats = _stats(tr_lengths)
    total = success_count + error_count

    # NOTE: the reference prints Median/Mean labels swapped relative to the
    # values (validate.rs:43-57 passes mean where "Median" is printed); we
    # keep the semantically correct ordering.
    print("Motifs per Locus - Range: [{},{}], Median: {:.2f}, Mean: {:.2f}, "
          "StdDev: {:.2f}".format(
              motifs_stats["min"], motifs_stats["max"],
              motifs_stats["median"], motifs_stats["mean"],
              motifs_stats["std_dev"]))
    print("TR Lengths - Range: [{},{}], Median: {:.2f}, Mean: {:.2f}, "
          "StdDev: {:.2f}".format(
              tr_stats["min"], tr_stats["max"], tr_stats["median"],
              tr_stats["mean"], tr_stats["std_dev"]))

    if error_count == 0:
        print("Validation successful. Loci pass = "
              + format_number_with_commas(success_count))
    else:
        print("Validation failed. Loci pass = {} ({:.2f}%), fail = {} "
              "({:.2f}%)".format(
                  format_number_with_commas(success_count),
                  success_count / total * 100.0,
                  format_number_with_commas(error_count),
                  error_count / total * 100.0))
