"""Span (flank alignment) and annotate (Viterbi) kernels of the port:
CUDA sources in ../csrc, plain PyTorch versions beside each wrapper."""
