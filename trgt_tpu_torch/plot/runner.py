"""`plot` command driver (ref: src/commands/plot.rs)."""

from ..io.fasta import FastaReader
from . import input as plot_input
from .params import pick_params
from .pipeplot import generate_image
from .plots import plot_alleles, plot_waterfall


def run_plot(args) -> None:
    genome = FastaReader(args.genome_path)
    locus = plot_input.get_locus(args.repeats_path, genome, args.tr_id,
                                 args.flank_len)
    reads = plot_input.get_reads(args.reads_path, locus,
                                 args.max_allele_reads)
    params = pick_params(locus.motifs, args.squished)
    if args.plot_type == "allele":
        allele_seqs = plot_input.get_alleles(args.bcf_path, locus)
        pipe_plot = plot_alleles(locus, args.show, allele_seqs, reads,
                                 params)
    else:
        pipe_plot = plot_waterfall(locus, args.show, reads, params)
    if getattr(args, "font_family", None):
        pipe_plot.font.family = args.font_family
    generate_image(pipe_plot, args.image_path)
