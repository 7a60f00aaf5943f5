"""Measurement tools for the CUDA kernels (run on a machine with a GPU)."""
