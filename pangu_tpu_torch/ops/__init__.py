"""Kernels of the port: each a hand-written CUDA kernel for Hopper with its
plain PyTorch version beside it in the same module."""
