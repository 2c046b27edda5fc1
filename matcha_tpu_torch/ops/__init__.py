"""Tensor ops of the port: masks and paths (`masks`), and the wrappers of the
CUDA kernels with their plain versions (`attention` for K1, `mrf` for K2)."""
