"""pangu_tpu_torch — the Pangu-Weather forecast and train steps in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of :mod:`pangu_tpu`, module for module: ``aux``, ``ops``,
``model``, ``interop``, ``rollout``, ``metrics`` and ``train`` each mirror
their JAX counterpart, which stays the numerical reference. The port keeps
its own copies of the JAX package's jax-free modules (``config``,
``geometry``, ``utils.flops``, ``interop.torch_import``); nothing in this
package imports jax or any module of ``pangu_tpu``.

Parameter names and shapes equal the reference torch state dict
(``pangu_tpu_torch.interop.torch_import.reference_key_map``), so a reference
``.pth`` loads with ``load_state_dict`` and JAX params convert through
:func:`pangu_tpu_torch.interop.from_jax.load_jax_params`.
"""

from __future__ import annotations

import torch

from pangu_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    PanguConfig,
    TrainConfig,
    pangu_pretrain,
    pangu_tiny,
)

__version__ = "0.1.0"


def dtype_of(name: str) -> torch.dtype:
    """Config dtype name ("float32", "bfloat16") -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
