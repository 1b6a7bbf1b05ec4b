"""Genotype driver and batch pipeline of the PyTorch port."""
