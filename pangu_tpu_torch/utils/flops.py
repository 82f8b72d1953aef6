"""Matmul FLOP counts of the model, from its shapes (the JAX package's
jax-free ``pangu_tpu/utils/flops.py``, imported, not copied)."""

from pangu_tpu.utils.flops import forward_matmul_flops, train_matmul_flops  # noqa: F401
