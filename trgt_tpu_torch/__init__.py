"""trgt_tpu_torch — the PyTorch/CUDA port of trgt_tpu.

It imports `torch` and never `jax`. The per-locus decision logic, I/O and
host twins are the JAX package's JAX-free modules, imported as they are;
this package owns what touches a device:

  device.py          --device cuda|cpu|host
  kernels/           hand-written CUDA kernels (csrc/*.cu), their plain
                     PyTorch versions, and the build that loads them
  engine/pipeline.py BatchPipeline with the span and annotate stages on
                     the port's kernels
  engine/runner.py   the genotype driver
  cli.py             `python -m trgt_tpu_torch genotype ...`
"""
