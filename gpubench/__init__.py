"""The benchmark of trgt_tpu_torch (BENCHMARK.json at the repository root):
its harness, input generator, plain reference and per-layer readers."""
