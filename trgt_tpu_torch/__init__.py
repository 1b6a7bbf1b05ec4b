"""trgt_tpu_torch — the PyTorch/CUDA port of trgt_tpu.

It imports `torch`, never `jax`, and nothing of the `trgt_tpu` package:
the per-locus decision logic, I/O and host twins are its own copies of
that package's numpy/stdlib modules, under the same sub-package and file
names.

  device.py          --device cuda|cpu|host
  kernels/           hand-written CUDA kernels (csrc/*.cu), their plain
                     PyTorch versions, the build that loads them, and the
                     host twins (align_host, span_window)
  io/, reads/, hmm/, genotype/, utils/
                     host-side I/O and per-locus logic (io/bcf.py BCF
                     reader and writer; io/cram_write.py a CRAM writer
                     that no command uses: tests and chip_smoke.py write
                     CRAM inputs with it)
  engine/pipeline.py BatchPipeline: every device stage on the port's
                     kernels, or on the host twins with --device host
  engine/runner.py   the genotype driver
  engine/validate.py the catalog validator
  merge/             streaming k-way VCF/BCF merge
  plot/              allele and waterfall plots (SVG, PDF; PNG by Pillow)
  cli.py             `python -m trgt_tpu_torch {genotype,validate,merge,
                     plot} ...`; merge, plot and validate are host code,
                     as in trgt_tpu, and never load torch
"""

# merge sniffs ##trgtVersion from VCF headers and applies pre-1.0 padding
# fixes (ref: src/merge/vcf_reader.rs:108-176), so the version reflects
# the replicated TRGT output semantics (v3.0.0); equal to trgt_tpu's.
__version__ = "3.0.0-tpu.0.1.0"
FULL_VERSION = __version__
