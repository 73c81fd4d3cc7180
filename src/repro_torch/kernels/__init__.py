"""Ternary kernels of the port: hand-written CUDA kernels under ``csrc/``,
their wrappers and plain PyTorch versions, and the public ops."""
