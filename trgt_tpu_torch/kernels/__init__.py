"""Kernels of the port: span (flank alignment), annotate (Viterbi),
cluster distances (edit distance) and consensus repair (end-to-end
alignment). CUDA sources in ../csrc, a plain PyTorch version beside each
wrapper, and the numpy/native host twins (align_host, span_window)."""
