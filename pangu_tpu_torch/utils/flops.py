"""Analytic matmul-FLOP counts for the Pangu backbone.

The port's own copy of ``pangu_tpu/utils/flops.py`` (the port imports nothing
of the JAX package); the TPU peak table and ``mfu``, keyed by JAX device
kinds, are left out. tests/test_torch_port_modules.py holds it to the original.

Counts multiply-accumulate FLOPs (2 per MAC) of every ``dot_general`` the
forward pass executes, derived statically from :class:`ModelConfig` via
:func:`compute_geometry` — no tracing, no compilation. The count mirrors the
actual execution geometry:

* every transformer block (qkv / scores / pv / proj / MLP) runs on the
  *window-padded* token grid ``z * h_pad * w`` (EarthSpecificLayer pads
  latitude once per stage, blocks.py:183-212), so padded tokens are counted
  as model FLOPs — the reference pads identically
  (reference models/layers.py:178-185), it is part of the architecture;
* attention scores/pv are per-window ``(T, d) x (d, T)`` dots summed over
  heads: ``2 * n_windows * T^2 * C`` each;
* elementwise work (LayerNorm, softmax, GELU, bias, normalization) is NOT
  counted — the standard matmul-only MFU convention.

Exactness is tested by summing the dot_general FLOPs of the traced jaxpr
(tests/test_flops.py): on the f32/XLA path the analytic total matches the
trace to the FLOP.

The train-step count uses the standard fwd+bwd = 3x convention (each matmul
has two backward matmuls of the same shape). Rematerialization recompute is
NOT counted as model FLOPs, so achieved train MFU slightly understates
hardware utilization under remat — stated in docs/PERFORMANCE.md.
"""

from __future__ import annotations

from typing import Dict

from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.geometry import compute_geometry


def forward_matmul_flops(cfg: ModelConfig, batch: int = 1) -> Dict[str, float]:
    """Matmul FLOPs of one forward pass, by component plus ``total``."""
    g = compute_geometry(cfg)
    c0 = cfg.dims[0]

    out: Dict[str, float] = {}

    # Patch embedding: per-token projections of the patchified fields.
    surf_tokens = g.h * g.w
    upper_tokens = g.z_upper * g.h * g.w
    out["patch_embed"] = 2.0 * batch * (
        surf_tokens * cfg.embed_surface_channels * c0
        + upper_tokens * cfg.embed_upper_channels * c0
    )

    # Transformer stages (blocks run on the window-padded grid).
    stages = (g.outer, g.inner, g.inner, g.outer)
    attn = mlp = 0.0
    for st, depth, dim in zip(stages, cfg.depths, cfg.dims):
        tokens = st.z * st.h_pad * st.w
        n_win = st.n_type_windows * st.n_lon_windows
        t = st.tokens_per_window
        qkv = 2.0 * tokens * dim * 3 * dim
        scores = 2.0 * n_win * t * t * dim  # summed over heads (heads*d = C)
        pv = scores
        proj = 2.0 * tokens * dim * dim
        attn += batch * depth * (qkv + scores + pv + proj)
        mlp += batch * depth * 2.0 * (2.0 * tokens * dim * cfg.mlp_ratio * dim)
    out["attention"] = attn
    out["mlp"] = mlp

    # Down/up sampling between the outer and inner grids.
    half_tokens = g.z * g.h2 * g.w2
    out["downsample"] = 2.0 * batch * half_tokens * (4 * cfg.dims[0]) * cfg.dims[1]
    out["upsample"] = 2.0 * batch * (
        half_tokens * cfg.dims[2] * (4 * cfg.dims[3])
        + g.z * g.h * g.w * cfg.dims[3] * cfg.dims[3]  # mixing linear
    )

    # Patch recovery heads on the skip-concatenated (2C) stream.
    cin = cfg.dims[0] + cfg.dims[3]
    out["patch_recovery"] = 2.0 * batch * (
        upper_tokens * cin * cfg.recovery_upper_channels
        + surf_tokens * cin * cfg.recovery_surface_channels
    )

    out["total"] = sum(out.values())
    return out


def train_matmul_flops(cfg: ModelConfig, batch: int = 1) -> float:
    """Fwd+bwd+update matmul FLOPs per train step: the standard 3x-forward
    convention (two same-shape backward matmuls per forward matmul; the Adam
    update is elementwise and uncounted). Remat recompute is excluded."""
    return 3.0 * forward_matmul_flops(cfg, batch)["total"]

