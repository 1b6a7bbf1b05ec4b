"""Command line of the PyTorch/CUDA port: `genotype` with the flags of
`trgt_tpu/cli.py` (ref: src/cli.rs GenotypeArgs) and `--device
cuda|cpu|host`. Presets come from `trgt_tpu.cli.apply_genotype_preset`,
so both packages resolve the same defaults."""

import argparse
import logging
import time

from trgt_tpu import FULL_VERSION
from trgt_tpu.cli import (_existing_file, _unit_float,
                          apply_genotype_preset, init_logger)

from .device import DEVICE_MODES


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
                   help="Read-extraction threads")
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
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    init_logger(args.verbose)
    log = logging.getLogger("trgt")
    start = time.time()
    log.info("Running trgt-tpu-torch %s %s", args.command, FULL_VERSION)
    try:
        apply_genotype_preset(args)
        from .engine.runner import run_genotype
        run_genotype(args)
    except Exception as e:
        log.error("%s", e)
        return 1
    log.info("Total execution time: %.2f s", time.time() - start)
    return 0
