"""3D windowed attention with Earth-Specific bias (port of
``pangu_tpu/model/attention.py``).

``EarthAttention3D`` consumes the padded token grid (B, Z, Hp, W, C). In
training with bf16 compute and ``use_kernel`` set it runs the training
attention K2 (``ops.fused_block_attention.fused_block_attention``), whose
backward is the flash backward K3; otherwise the plain windowed path
(partition, per-head scores + earth bias [+ shift mask], f32 softmax,
reverse), the JAX package's XLA path. Active dropout (training, rate > 0)
and unmerged LoRA adapters on ``linear1``/``linear2`` take the plain path,
as in JAX: the kernel models neither. With ``epilogue=(ln_scale, ln_bias)``
and ``use_kernel`` set it runs K2's LN-epilogue mode ``x + LN(attn(x))`` in
any mode; without ``use_kernel`` the epilogue raises, as the JAX module
asserts. The fused inference block does not call it: ``EarthSpecificBlock``
hands its weights to the block kernel instead.

Dropout and LoRA live here for every module of the model:

* ``dropout`` draws its keep mask from a fresh ``torch.Generator`` seeded
  with a per-site seed that the caller drew before any checkpointed stage
  (``train_seeds``), so a checkpoint's recompute draws the same mask;
  ``torch.utils.checkpoint`` replays only the default generators. The bits
  cannot match JAX's ``nn.Dropout`` draws; the keep-scaling is flax's
  (``x / keep`` where kept, else 0).
* A ``LoraAdapter`` rides an ``nn.Linear`` as its ``lora`` attribute
  (``train.lora.attach_lora``). Merged, the layer's weight is
  ``W + ((A @ B) * alpha/r)^T``, recomputed from A and B at every use
  (``linear_weight``), so a recompute under checkpoint differentiates A and B
  and every kernel still runs. Unmerged, the site adds peft's
  ``scaling * dropout(x) @ A @ B`` in f32 (``lora_tap``, the JAX
  ``model/attention.py::lora_tap``) and leaves the kernels.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pangu_tpu_torch.geometry import StageGeometry
from pangu_tpu_torch.ops.fused_block_attention import dense, dot_f32, fused_block_attention
from pangu_tpu_torch.ops.windows import window_partition, window_reverse
from pangu_tpu_torch.parallel.mesh import active_mesh
from pangu_tpu_torch.parallel.spatial import active_slab


@dataclasses.dataclass
class LoraAdapter:
    """A LoRA adapter on one ``nn.Linear``: ``a`` (in, r) and ``b`` (r, out),
    the JAX package's layout; ``scaling`` alpha/r; ``rate`` the adapter
    dropout of the unmerged form; ``merged`` picks the form."""

    a: torch.Tensor
    b: torch.Tensor
    scaling: float
    rate: float
    merged: bool


def _adapter(linear: nn.Linear) -> Optional[LoraAdapter]:
    return linear.__dict__.get("lora")


def unmerged(*linears: nn.Linear) -> bool:
    """Whether an unmerged adapter rides any of ``linears``."""
    return any(a is not None and not a.merged for a in map(_adapter, linears))


def draws(rate: float, *linears: nn.Linear) -> bool:
    """Whether a training call draws masks: dropout at ``rate`` > 0, or an
    unmerged adapter with dropout on one of ``linears``."""
    return rate > 0.0 or any(a is not None and not a.merged and a.rate > 0.0
                             for a in map(_adapter, linears))


def linear_weight(linear: nn.Linear) -> torch.Tensor:
    """The (out, in) weight the layer computes with: with a merged adapter
    ``W + ((A @ B) * scaling)^T`` (``pangu_tpu/train/lora.py::merge_params``),
    else ``W``."""
    ad = _adapter(linear)
    if ad is None or not ad.merged:
        return linear.weight
    return linear.weight + ((ad.a @ ad.b) * ad.scaling).t().to(linear.weight.dtype)


def dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Inverted dropout of ``x`` in its dtype (flax ``nn.Dropout``): kept
    elements divided by keep = 1 - rate rounded to x's dtype (flax's weakly
    typed keep takes it), the mask drawn from a generator seeded with
    ``seed``. The identity at rate 0 or without a seed (eval)."""
    if rate <= 0.0 or seed is None:
        return x
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(seed)
    u = torch.rand(x.shape, generator=gen, device=x.device)
    kept = x / torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(u < keep, kept, torch.zeros((), dtype=x.dtype, device=x.device))


def lora_tap(linear: nn.Linear, x: torch.Tensor,
             seed: Optional[int] = None) -> Optional[torch.Tensor]:
    """The unmerged adapter's contribution ``scaling * dropout(x) @ A @ B``
    in f32 for the site ``linear`` fed ``x`` (the JAX ``lora_tap``: dropout
    per element, in training, where ``seed`` is given); None without an
    unmerged adapter."""
    ad = _adapter(linear)
    if ad is None or ad.merged:
        return None
    xd = dropout(x.float(), ad.rate, seed)
    return torch.matmul(torch.matmul(xd, ad.a.float()), (ad.b * ad.scaling).float())


def add_tap(y: torch.Tensor, linear: nn.Linear, x: torch.Tensor,
            seed: Optional[int] = None) -> torch.Tensor:
    """``y`` plus the unmerged adapter's contribution of the site, in y's dtype."""
    d = lora_tap(linear, x, seed)
    return y if d is None else y + d.to(y.dtype)


def train_seeds(module: nn.Module, generator: Optional[torch.Generator], sites: Sequence[str],
                rate: float, *linears: nn.Linear) -> Optional[Dict[str, int]]:
    """One seed per site of ``sites``, drawn from ``generator``, for a call
    of ``module`` that draws masks (in training, ``draws(rate, *linears)``);
    else None. Under an active mesh the rank is folded into each seed (rank
    0 keeps the drawn one): the generator is the same on every rank, so
    unfolded seeds would drop the same elements of different samples. The
    masks under data parallelism are per-rank draws (they differ from
    flax's draws anyway). Outside a layer's slab (``parallel.spatial.on_slab``)
    a module runs on the whole grid and folds the rank's data coordinate
    instead, so the spatial peers of a sample draw the same masks and stay
    replicas."""
    if not (module.training and draws(rate, *linears)):
        return None
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    # one draw for all sites; on a card's generator, one read back to the host
    seeds = torch.randint(2**62, (len(sites),), generator=generator, device=generator.device)
    mesh = active_mesh()
    rank = 0 if mesh is None else mesh.rank if active_slab() else mesh.data_rank
    return {site: (s + rank * _RANK_STRIDE) % 2**62 for site, s in zip(sites, seeds.tolist())}


#: the odd constant that folds a rank into a dropout seed (2**64 / golden ratio)
_RANK_STRIDE = 0x9E3779B97F4A7C15


#: the random sites of one attention sublayer: its two dropouts and two adapters
ATTENTION_SITES = ("attn_drop", "proj_drop", "qkv", "proj")


@functools.lru_cache(maxsize=None)
def shift_attention_mask(stage: StageGeometry) -> np.ndarray:
    """Static additive mask (n_type, T, T) for the shifted-window pass.

    Reproduces the reference's region labelling, including its non-Swin
    middle latitude slice ``[wh, Hp - wh/2)``; longitude needs no mask (the
    roll is circular, as the sphere is). Fill value -100, not -inf."""
    wz, wh, ww = stage.window
    z, hp = stage.z, stage.h_pad
    label = np.zeros((z, hp), np.int32)
    cnt = 0
    z_slices = (slice(0, -wz), slice(-wz, -wz // 2), slice(-wz // 2, None))
    h_slices = (slice(0, -wh), slice(wh, -wh // 2), slice(-wh // 2, None))
    for zs in z_slices:
        for hs in h_slices:
            label[zs, hs] = cnt
            cnt += 1
    # (Zn, wz, Hn, wh) -> type-major token labels, broadcast over longitude
    lab = label.reshape(z // wz, wz, hp // wh, wh)
    lab = lab.transpose(0, 2, 1, 3).reshape(stage.n_type_windows, wz, wh)
    lab = np.broadcast_to(lab[..., None], (stage.n_type_windows, wz, wh, ww))
    lab = lab.reshape(stage.n_type_windows, stage.tokens_per_window)
    diff = lab[:, :, None] - lab[:, None, :]
    return np.where(diff != 0, np.float32(-100.0), np.float32(0.0))


class EarthAttention3D(nn.Module):
    """Multi-head window attention with a dense bias per window type.

    Parameters as in the reference state dict: ``linear1`` (3C, C) qkv,
    ``linear2`` (C, C) projection, ``earth_specific_bias``
    (1, n_type, heads, T, T)."""

    def __init__(self, dim: int, heads: int, stage: StageGeometry, use_kernel: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dim, self.heads, self.window = dim, heads, stage.window
        self.use_kernel, self.dropout_rate = use_kernel, dropout_rate
        self.linear1 = nn.Linear(dim, 3 * dim)
        self.linear2 = nn.Linear(dim, dim)
        t = stage.tokens_per_window
        self.earth_specific_bias = nn.Parameter(
            torch.zeros(1, stage.n_type_windows, heads, t, t))

    def plain_only(self) -> bool:
        """Whether this call must take the plain path: active dropout or an
        unmerged adapter (pangu_tpu/model/attention.py:216-220)."""
        return ((self.training and self.dropout_rate > 0.0)
                or unmerged(self.linear1, self.linear2))

    def uses_kernel(self, x: torch.Tensor) -> bool:
        """Whether a call on ``x`` without an epilogue runs K2."""
        return (self.training and self.use_kernel and x.dtype == torch.bfloat16
                and not self.plain_only())

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                epilogue: Optional[tuple] = None,
                seeds: Optional[Dict[str, int]] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, Z, Hp, W, C) in the compute dtype -> same shape and dtype;
        ``epilogue`` (ln_scale, ln_bias) adds the block's post-norm residual
        ``x + LN(.)``. ``seeds`` (``train_seeds`` of ``ATTENTION_SITES``)
        draw the dropout masks in training; required when one is active.
        ``bias`` is the earth bias (nT, heads, T, T) f32 of ``x``'s windows
        (on a spatial slab, cut to its lat windows like ``mask``), by default
        the whole table."""
        if bias is None:
            bias = self.earth_specific_bias[0].float()
        cdt = x.dtype
        b, z, hp, w, c = x.shape
        d = c // self.heads
        if epilogue is not None and (not self.use_kernel or self.plain_only()):
            raise ValueError("the fused epilogue needs the kernel route (use_kernel) and "
                             "no active dropout or unmerged adapter")
        if epilogue is not None or self.uses_kernel(x):
            ln_s, ln_b = (None, None) if epilogue is None else (epilogue[0].float(),
                                                                epilogue[1].float())
            return fused_block_attention(
                x, linear_weight(self.linear1).to(cdt), self.linear1.bias.to(cdt),
                linear_weight(self.linear2).to(cdt), self.linear2.bias.to(cdt),
                bias, mask, ln_s, ln_b,
                self.window, self.heads, d ** -0.5)
        seed = seed_of(seeds, self.training)
        rate = self.dropout_rate if self.training else 0.0
        if self.training and seeds is None and draws(rate, self.linear1, self.linear2):
            raise ValueError("dropout in training needs its seeds (train_seeds)")
        xw = window_partition(x, self.window)  # (B, nW, nT, T, C)
        n_w, n_t, t = xw.shape[1:4]
        qkv = add_tap(dense(xw, linear_weight(self.linear1), self.linear1.bias),
                      self.linear1, xw, seed("qkv"))
        q, k, v = qkv.reshape(b, n_w, n_t, t, 3, self.heads, d).permute(4, 0, 1, 2, 5, 3, 6)
        attn = dot_f32(q * d ** -0.5, k.transpose(-1, -2))
        attn = attn + bias
        if mask is not None:
            attn = attn + mask.float()[:, None]
        attn = dropout(torch.softmax(attn, dim=-1).to(cdt), rate, seed("attn_drop"))
        out = dot_f32(attn, v).to(cdt)  # (B, nW, nT, heads, T, d)
        out = out.permute(0, 1, 2, 4, 3, 5).reshape(b, n_w, n_t, t, c)
        out = add_tap(dense(out, linear_weight(self.linear2), self.linear2.bias),
                      self.linear2, out, seed("proj"))
        out = dropout(out, rate, seed("proj_drop"))
        return window_reverse(out, self.window, z, hp, w)


def seed_of(seeds: Optional[Dict[str, int]], training: bool):
    """site -> its seed in training, else None (eval draws nothing)."""
    def seed(site: str) -> Optional[int]:
        return seeds[site] if training and seeds is not None else None
    return seed
