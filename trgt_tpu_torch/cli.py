"""Command line of the PyTorch/CUDA port: `genotype`, `validate`, `merge`
and `plot` with the flags, presets and defaults of `trgt_tpu/cli.py` (ref:
src/cli.rs). `genotype` alone takes `--device cuda|cpu|host`: the other
three are host code, as in the reference, and never load torch."""

import argparse
import logging
import os
import time

from . import FULL_VERSION
from .device import DEVICE_MODES


def _existing_file(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"File does not exist: {path}")
    return path


def _unit_float(s: str) -> float:
    v = float(s)
    if not 0.0 <= v <= 1.0:
        raise argparse.ArgumentTypeError(
            f"The value must be between 0.0 and 1.0: {s}")
    return v


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="trgt-tpu-torch",
        description="Tandem Repeat Genotyping Tool (PyTorch/CUDA port)")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="Specify multiple times to increase verbosity")
    parser.add_argument("--version", action="version",
                        version=f"trgt-tpu-torch {FULL_VERSION}")
    sub = parser.add_subparsers(dest="command", required=True)

    g = sub.add_parser("genotype", help="Tandem Repeat Genotyper")
    g.add_argument("-g", "--genome", dest="genome_path", metavar="FASTA",
                   type=_existing_file, required=True)
    g.add_argument("-r", "--reads", dest="reads_path", metavar="READS",
                   type=_existing_file, required=True)
    g.add_argument("-b", "--repeats", dest="repeats_path", metavar="REPEATS",
                   type=_existing_file, required=True)
    g.add_argument("-o", "--output-prefix", dest="output_prefix",
                   required=True)
    g.add_argument("-k", "--karyotype", default="XX")
    g.add_argument("-t", "--threads", dest="num_threads", type=int, default=1,
                   help="Worker processes, each on --device, where the "
                        "catalog holds enough loci for each (engine/runner.py "
                        "POOL_MIN_LOCI); otherwise, and with "
                        "TRGT_TPU_PROCS=0, read-extraction threads of one "
                        "process")
    g.add_argument("--preset", default="wgs", choices=["wgs", "targeted"])
    g.add_argument("--sample-name", dest="sample_name", default=None)
    g.add_argument("--genotyper", default=None, choices=["size", "cluster"])
    g.add_argument("--aln-scoring", dest="aln_scoring", default=None)
    g.add_argument("--min-flank-id-frac", dest="min_flank_id_frac",
                   type=_unit_float, default=None)
    g.add_argument("--flank-len", dest="flank_len", type=int, default=None)
    g.add_argument("--output-flank-len", dest="output_flank_len", type=int,
                   default=50)
    # accepted-but-unused, as in the reference (cli.rs:319)
    g.add_argument("--fixed-flanks", action="store_true")
    g.add_argument("--min-read-quality", dest="min_hifi_read_qual",
                   type=float, default=None)
    g.add_argument("--disable-bam-output", action="store_true")
    g.add_argument("--max-depth", dest="max_depth", type=int, default=None)
    g.add_argument("--device", default="cuda", choices=DEVICE_MODES,
                   help="cuda = hand-written CUDA kernels; cpu = their "
                        "plain PyTorch versions; host = the host twins")
    g.add_argument("--shard-index", dest="shard_index", type=int,
                   default=None,
                   help="Process this catalog shard (0-based); with "
                        "--shard-count")
    g.add_argument("--shard-count", dest="shard_count", type=int,
                   default=None)
    g.add_argument("--batch-size", dest="batch_size", type=int, default=None,
                   help="Loci per batch (default 256 on cuda, 64 otherwise)")

    # validate (ref: cli.rs ValidateArgs)
    v = sub.add_parser("validate", help="Tandem Repeat Catalog Validator")
    v.add_argument("-g", "--genome", dest="genome_path", metavar="FASTA",
                   type=_existing_file, required=True)
    v.add_argument("-b", "--repeats", dest="repeats_path", metavar="REPEATS",
                   type=_existing_file, required=True)
    v.add_argument("--flank-len", dest="flank_len", type=int, default=250)

    # merge (ref: cli.rs:73-180 MergeArgs)
    m = sub.add_parser("merge", help="Tandem Repeat VCF Merger")
    m.add_argument("--vcf", dest="vcfs", nargs="+", default=None)
    m.add_argument("--vcf-list", dest="vcf_list", type=_existing_file,
                   default=None)
    m.add_argument("-g", "--genome", dest="genome_path",
                   type=_existing_file, default=None)
    m.add_argument("-o", "--output", default=None)
    m.add_argument("-O", "--output-type", dest="output_type", default=None,
                   choices=["u", "b", "v", "z"])
    m.add_argument("--skip-n", dest="skip_n", type=int, default=None)
    m.add_argument("--process-n", dest="process_n", type=int, default=None)
    m.add_argument("--print-header", action="store_true")
    m.add_argument("--force-single", action="store_true")
    m.add_argument("--force-samples", action="store_true")
    m.add_argument("--no-version", action="store_true")
    m.add_argument("--missing-to-ref", action="store_true")
    m.add_argument("--strategy", default="exact", choices=["exact"])
    m.add_argument("--quit-on-errors", action="store_true")
    m.add_argument("--contig", dest="contigs", nargs="+", default=None)

    # plot (ref: cli.rs PlotArgs)
    p = sub.add_parser("plot", help="Tandem Repeat Plotter")
    p.add_argument("-g", "--genome", dest="genome_path", metavar="FASTA",
                   type=_existing_file, required=True)
    p.add_argument("-b", "--repeats", dest="repeats_path", metavar="REPEATS",
                   type=_existing_file, required=True)
    p.add_argument("-v", "--vcf", dest="bcf_path", metavar="VCF",
                   type=_existing_file, required=True)
    p.add_argument("-r", "--spanning-reads", dest="reads_path",
                   metavar="READS", type=_existing_file, required=True)
    p.add_argument("--repeat-id", dest="tr_id", required=True)
    p.add_argument("-o", "--image", dest="image_path", metavar="IMAGE",
                   required=True)
    p.add_argument("--plot-type", dest="plot_type", default="allele",
                   choices=["allele", "waterfall"])
    p.add_argument("--show", default="motifs", choices=["motifs", "meth"])
    p.add_argument("--flank-len", dest="flank_len", type=int, default=50)
    p.add_argument("--max-allele-reads", dest="max_allele_reads", type=int,
                   default=None)
    p.add_argument("--squished", action="store_true")
    p.add_argument("--font-family", dest="font_family", default=None)
    return parser


def apply_genotype_preset(args) -> None:
    """Preset-conditional defaults (ref: cli.rs default_value_if at
    265,275,287,299,326,341)."""
    targeted = args.preset == "targeted"
    if args.genotyper is None:
        args.genotyper = "cluster" if targeted else "size"
    if args.aln_scoring is None:
        args.aln_scoring = "1,0,1" if targeted else "2,5,1"
    if args.min_flank_id_frac is None:
        args.min_flank_id_frac = 0.8 if targeted else 0.7
    if args.flank_len is None:
        args.flank_len = 200 if targeted else 250
    if args.min_hifi_read_qual is None:
        args.min_hifi_read_qual = -1.0 if targeted else 0.98
    if args.max_depth is None:
        args.max_depth = 10000 if targeted else 250


def init_logger(verbosity: int) -> None:
    level = [logging.WARNING, logging.INFO, logging.DEBUG][min(verbosity, 2)]
    logging.basicConfig(
        level=level,
        format="[%(asctime)s %(levelname)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    init_logger(args.verbose)
    log = logging.getLogger("trgt")
    start = time.time()
    log.info("Running trgt-tpu-torch %s %s", args.command, FULL_VERSION)
    try:
        if args.command == "genotype":
            apply_genotype_preset(args)
            from .engine.runner import run_genotype
            run_genotype(args)
        elif args.command == "validate":
            from .engine.validate import run_validate
            run_validate(args)
        elif args.command == "merge":
            from .merge.runner import run_merge
            run_merge(args)
        elif args.command == "plot":
            from .plot.runner import run_plot
            run_plot(args)
    except Exception as e:
        log.error("%s", e)
        return 1
    log.info("Total execution time: %.2f s", time.time() - start)
    return 0
