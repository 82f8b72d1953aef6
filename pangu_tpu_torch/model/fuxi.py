"""FuXi (Chen et al. 2023, "FuXi: a cascade machine learning forecasting
system for 15-day global weather forecast", arXiv:2306.12873) in PyTorch:
the network of FuXi-Short, FuXi-Medium and FuXi-Long, which differ only in
their weights.

One step maps two states (t - 6 h, t) of ``variables`` fields on the
0.25-degree grid to the state at t + 6 h::

    cube embedding   Conv3d (2, 4, 4) / (2, 4, 4) over (time, lat, lon),
                     V -> C on (lat // 4) x (lon // 4), then LayerNorm
    Down Block       Conv2d 3x3 stride 2 -> residual block        (C, h/2 x w/2)
    48 Swin V2 blocks at C on h/2 x w/2, shifted every other one
    Up Block         concat(Down out, blocks out) (2C) -> ConvTranspose2d
                     2x2 stride 2 -> residual block               (C, h x w)
    head             Linear(C -> V * 4 * 4) per token, pixel shuffle to
                     (lat - 1) x lon, bilinear to lat x lon: the next state,
                     normalized

The residual block is ``x + SiLU(GN(conv3x3(SiLU(GN(conv3x3(x))))))``. A
Swin V2 block (Liu et al. 2022, arXiv:2111.09883) is res-post-norm,
``x = x + LN(attn(x))``, ``x = x + LN(mlp(x))``, with scaled cosine window
attention ``cos(q, k) * exp(min(logit_scale, log 100)) + B + mask``: q and v
projections with biases, k without; ``B = 16 sigmoid(MLP(offsets))``, the
relative offsets of a window scaled to +-8 and log-spaced. A shifted block
rolls the token grid by half a window and masks the regions the roll joins
on both axes (longitude does not wrap, as in Swin V2).

Where the paper is silent the model takes the values that
``benchmark/configs/fuxi_short_bf16.json`` lists under ``assumed``: window
9x9 (shift 4, tiling the 90x180 token grid), heads of 32, GroupNorm of 32
groups, the residual and Up Blocks above, the embedding dropping the last
latitude row, the head above, and no inputs beside the two states.

Numerics in ``compute_dtype`` bf16: products in bf16 with f32 accumulation
(cuBLAS and cuDNN; the window attention, on the card, the cosine window
attention kernel of ``ops/cosine_attention.py``); the LayerNorm and
GroupNorm statistics, the cosine normalization and the softmax in f32; the
state in f32 and physical units. In f32 the attention is the plain chain of
PyTorch calls (``scaled_dot_product_attention`` on gathered windows). :meth:`FuxiModel.freeze` casts the weights
that enter products and LayerNorms to the compute dtype once and computes
the position-bias tables once (they depend on the weights alone), so a
step casts and tabulates nothing. Under a running profiler the step is
``fuxi.embed``, ``fuxi.down``, one ``fuxi.block`` per block holding one
``fuxi.block.attention`` (everything between the qkv and the output
projections), ``fuxi.up`` and ``fuxi.head`` (``utils.profiling.span``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pangu_tpu_torch import dtype_of
from pangu_tpu_torch.model.blocks import Mlp
from pangu_tpu_torch.ops.cosine_attention import (MASKED, cosine_window_attention,
                                                  cosine_window_attention_reference)
from pangu_tpu_torch.ops.windows import window_partition
from pangu_tpu_torch.utils.profiling import span

#: Swin V2's bounds: the largest logit scale, the reach of the scaled
#: offsets and the position bias's range (the shift mask's value is
#: ``MASKED``)
LOGIT_SCALE_MAX = math.log(100.0)
OFFSET_REACH = 8.0
BIAS_RANGE = 16.0


@dataclass(frozen=True)
class FuxiConfig:
    """The network's widths and grid. Defaults are FuXi's (``fuxi_short``)."""

    lat: int = 721
    lon: int = 1440
    variables: int = 70
    input_steps: int = 2
    cube: Tuple[int, int, int] = (2, 4, 4)  # (time, lat, lon)
    dim: int = 1536
    depth: int = 48
    heads: int = 48
    window: Tuple[int, int] = (9, 9)  # (lat, lon) tokens
    mlp_ratio: int = 4
    cpb_hidden: int = 512
    groups: int = 32
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        h, w = self.grid
        wh, ww = self.window
        if self.cube[0] != self.input_steps:
            raise ValueError(f"the cube's time extent {self.cube[0]} must be the "
                             f"{self.input_steps} input steps")
        if h % 2 or w % 2 or (h // 2) % wh or (w // 2) % ww:
            raise ValueError(f"the embedding's {h}x{w} grid must halve into whole "
                             f"{wh}x{ww} windows")
        if self.param_dtype != "float32":
            raise ValueError("the parameters are f32 masters; the step casts them once")
        if self.dim % self.heads or self.dim % self.groups:
            raise ValueError(f"C {self.dim} must divide into {self.heads} heads and "
                             f"{self.groups} groups")

    @property
    def grid(self) -> Tuple[int, int]:
        """(rows, columns) of the cube embedding: the last latitude row that
        a (2, 4, 4)-stride convolution does not reach is dropped."""
        return (self.lat - self.cube[1]) // self.cube[1] + 1, self.lon // self.cube[2]

    @property
    def tokens(self) -> Tuple[int, int]:
        """(rows, columns) of the Swin blocks' token grid."""
        h, w = self.grid
        return h // 2, w // 2


def fuxi_short() -> FuxiConfig:
    """FuXi-Short at its published widths (steps 1-20, days 0-5)."""
    return FuxiConfig()


def fuxi_tiny(**kw) -> FuxiConfig:
    """A CPU size with every branch of the real one: an odd latitude whose
    last row the embedding drops, a 6x12 token grid of 3x3 windows (shift
    1, so the mask has all nine regions), four blocks (shifted and
    unshifted twice each), f32."""
    defaults = dict(lat=49, lon=96, variables=5, dim=32, depth=4, heads=4, window=(3, 3),
                    cpb_hidden=16, groups=4, compute_dtype="float32")
    defaults.update(kw)
    return FuxiConfig(**defaults)


@dataclass
class FuxiConstants:
    """The normalization statistics of the state's variables, (1, V, 1, 1) f32."""

    mean: torch.Tensor
    std: torch.Tensor


# ---- window geometry -------------------------------------------------------------------


def log_spaced_offsets(window: Tuple[int, int]) -> torch.Tensor:
    """(2 wh - 1, 2 ww - 1, 2) f32: every relative (lat, lon) offset of a
    window, scaled to +-8 and mapped by ``sign(x) log2(1 + |x|) / log2(8)``
    (Swin V2's continuous position bias input)."""
    axes = [torch.arange(-(n - 1), n, dtype=torch.float32) * (OFFSET_REACH / (n - 1))
            for n in window]
    t = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(OFFSET_REACH)


def relative_index(window: Tuple[int, int]) -> torch.Tensor:
    """(T, T) int64: row of :func:`log_spaced_offsets` (flattened) that holds
    the offset of token i from token j of a window, tokens lat-major."""
    wh, ww = window
    coords = torch.stack(torch.meshgrid(torch.arange(wh), torch.arange(ww), indexing="ij"))
    rel = coords.flatten(1)[:, :, None] - coords.flatten(1)[:, None, :]
    return (rel[0] + wh - 1) * (2 * ww - 1) + rel[1] + ww - 1


def window_order(h: int, w: int, window: Tuple[int, int], shifted: bool) -> torch.Tensor:
    """(h * w,) int64: the grid token at each place of the (rolled, when
    ``shifted``) grid's windows, in ``ops.windows.window_partition``'s order
    (longitude windows, latitude windows, then the window's tokens)."""
    idx = torch.arange(h * w).view(h, w)
    if shifted:
        idx = torch.roll(idx, [-(n // 2) for n in window], dims=(0, 1))
    return window_partition(idx.view(1, 1, h, w, 1), (1, *window)).reshape(-1)


def shift_mask(h: int, w: int, window: Tuple[int, int]) -> torch.Tensor:
    """(nW, T, T) f32 in :func:`window_order`'s window order: -100 between
    tokens of different regions of the rolled grid, 0 within one. The
    regions are Swin's: ``[0, -w), [-w, -s), [-s, end)`` on each axis."""
    label = torch.zeros(h, w)
    n = 0
    (wh, ww), (sh, sw) = window, [k // 2 for k in window]
    for rows in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for cols in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            label[rows, cols] = n
            n += 1
    lab = window_partition(label.view(1, 1, h, w, 1), (1, *window)).reshape(-1, wh * ww)
    return torch.where(lab[:, :, None] != lab[:, None, :], MASKED, 0.0)


def shift_labels(h: int, w: int, window: Tuple[int, int]) -> torch.Tensor:
    """(h * w,) int8 in :func:`window_order`'s places: the region of the
    rolled grid each place lies in, ``3 * lat region + lon region``, a
    region of an axis of n positions ``0`` below ``n - window``, ``1``
    below ``n - shift``, else ``2``. Two places of a window are masked
    (:func:`shift_mask`) exactly where their labels differ."""
    def region(n, k):
        i = torch.arange(n)
        return (i >= n - k).to(torch.int8) + (i >= n - k // 2).to(torch.int8)

    label = 3 * region(h, window[0])[:, None] + region(w, window[1])[None, :]
    return window_partition(label.view(1, 1, h, w, 1), (1, *window)).reshape(-1)


# ---- layers ----------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm over the channels in x's dtype, statistics in f32 (one
    fused kernel)."""
    return F.layer_norm(x, x.shape[-1:], norm.weight.to(x.dtype), norm.bias.to(x.dtype),
                        norm.eps)


def conv(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """``layer`` (a Conv2d or ConvTranspose2d) on the channels-last grid
    (B, H, W, C), in x's dtype; the result channels-last and contiguous."""
    op = F.conv_transpose2d if isinstance(layer, nn.ConvTranspose2d) else F.conv2d
    y = op(x.permute(0, 3, 1, 2), layer.weight.to(x.dtype), layer.bias.to(x.dtype),
           stride=layer.stride, padding=layer.padding)
    return y.permute(0, 2, 3, 1).contiguous()


def group_norm_silu(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """SiLU(GroupNorm(x)) of the channels-last grid (B, H, W, C) in f32,
    rounded once to x's dtype."""
    b, h, w, c = x.shape
    g = norm.num_groups
    y = x.float().view(b, h * w, g, c // g)
    var, mean = torch.var_mean(y, dim=(1, 3), keepdim=True, correction=0)
    scale = torch.rsqrt(var + norm.eps) * norm.weight.float().view(1, 1, g, c // g)
    shift = norm.bias.float().view(1, 1, g, c // g) - mean * scale
    return F.silu(torch.addcmul(shift, y, scale), inplace=True).view(b, h, w, c).to(x.dtype)


class ResidualBlock(nn.Module):
    """``h = SiLU(GN(conv3x3(x)))``, ``h = SiLU(GN(conv3x3(h)))``, ``x + h``."""

    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.norm1 = nn.GroupNorm(groups, dim)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = group_norm_silu(conv(x, self.conv1), self.norm1)
        return x + group_norm_silu(conv(h, self.conv2), self.norm2)


class DownBlock(nn.Module):
    """Conv2d 3x3 stride 2, then a residual block."""

    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, stride=2, padding=1)
        self.res = ResidualBlock(dim, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res(conv(x, self.conv))


class UpBlock(nn.Module):
    """ConvTranspose2d(2C -> C) 2x2 stride 2 of the skip concat, then a
    residual block."""

    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(2 * dim, dim, 2, stride=2)
        self.res = ResidualBlock(dim, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res(conv(x, self.conv))


class CubeEmbedding(nn.Module):
    """Conv3d over (time, lat, lon) with kernel = stride, then LayerNorm."""

    def __init__(self, cfg: FuxiConfig):
        super().__init__()
        self.cube = cfg.cube
        self.proj = nn.Conv3d(cfg.variables, cfg.dim, cfg.cube, stride=cfg.cube)
        self.norm = nn.LayerNorm(cfg.dim)

    def forward(self, states: Tuple[torch.Tensor, ...], k: FuxiConstants,
                grid: Tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
        """Physical states (B, V, lat, lon), oldest first -> (B, h, w, C):
        each normalized in f32 and laid out as the convolution's patches
        (V, time, lat, lon-major) in ``dtype``, then one product."""
        (h, w), (_, kh, kw) = grid, self.cube
        b, v = states[0].shape[:2]
        patches = states[0].new_empty((b, h, w, v, len(states), kh, kw), dtype=dtype)
        inv = 1.0 / k.std
        shift = -k.mean * inv
        for t, x in enumerate(states):
            n = torch.addcmul(shift, x[:, :, :h * kh, :w * kw], inv)
            patches[:, :, :, :, t].copy_(n.view(b, v, h, kh, w, kw).permute(0, 2, 4, 1, 3, 5))
        weight = self.proj.weight.to(dtype).reshape(self.proj.out_channels, -1)
        x = F.linear(patches.view(b, h, w, -1), weight, self.proj.bias.to(dtype))
        return layer_norm(x, self.norm)


class CosineWindowAttention(nn.Module):
    """Swin V2's parameters of one block's attention (names as Swin V2's):
    ``qkv`` (no bias), ``q_bias``, ``v_bias``, ``logit_scale`` (heads, 1, 1),
    ``cpb_mlp`` (2 -> hidden, ReLU, -> heads, no bias) and ``proj``."""

    def __init__(self, dim: int, heads: int, cpb_hidden: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.full((heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, cpb_hidden), nn.ReLU(inplace=True),
                                     nn.Linear(cpb_hidden, heads, bias=False))
        self.proj = nn.Linear(dim, dim)

    def position_bias(self, window: Tuple[int, int]) -> torch.Tensor:
        """(heads, T, T) f32: ``16 sigmoid(cpb_mlp(offsets))`` of each
        (query, key) of a window."""
        dev = self.q_bias.device
        table = self.cpb_mlp(log_spaced_offsets(window).to(dev)).view(-1, self.heads)
        t = window[0] * window[1]
        bias = table[relative_index(window).to(dev).view(-1)].view(t, t, self.heads)
        return BIAS_RANGE * torch.sigmoid(bias.permute(2, 0, 1).float().contiguous())

    def tables(self, window: Tuple[int, int], dtype: torch.dtype) -> "BlockTables":
        """What the block's weights fix: the qkv bias, each head's
        temperature beside k's 1, and the position bias (1, heads, T, T) less its row
        maxima (a softmax ignores a constant per row; the largest entries
        keep ``dtype``'s finest steps)."""
        with torch.no_grad():
            bias = self.position_bias(window)
            bias = bias - bias.amax(-1, keepdim=True)
            temp = torch.clamp(self.logit_scale.float(), max=LOGIT_SCALE_MAX).exp()
            scale = torch.stack([temp, torch.ones_like(temp)]).view(2, self.heads, 1)
            qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        return BlockTables(qkv_bias.to(dtype), scale, bias[None].to(dtype))


class BlockTables(NamedTuple):
    qkv_bias: torch.Tensor  # (3C,) compute dtype
    scale: torch.Tensor  # (2, heads, 1) f32: q's temperature, k's 1
    bias: torch.Tensor  # (1, heads, T, T) compute dtype


class Tables(NamedTuple):
    """What a step reads beside the weights: per shift (unshifted, shifted)
    the window order (int32) and its inverse (int64), the shift's region
    labels (int8, :func:`shift_labels`), and each block's
    :class:`BlockTables`."""

    order: Tuple[torch.Tensor, torch.Tensor]
    inverse: Tuple[torch.Tensor, torch.Tensor]
    labels: torch.Tensor
    blocks: List[BlockTables]


class SwinV2Block(nn.Module):
    """One res-post-norm block on the token grid (B, H, W, C)."""

    def __init__(self, cfg: FuxiConfig):
        super().__init__()
        self.attn = CosineWindowAttention(cfg.dim, cfg.heads, cfg.cpb_hidden)
        self.norm1 = nn.LayerNorm(cfg.dim)
        self.mlp = Mlp(cfg.dim, cfg.mlp_ratio)
        self.norm2 = nn.LayerNorm(cfg.dim)

    def forward(self, x: torch.Tensor, bt: BlockTables, order: torch.Tensor,
                inverse: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """``labels`` the shift's region labels on a shifted block, else
        None. A bf16 block goes to ``cosine_window_attention`` (the kernel on
        the card), any other dtype to its plain version."""
        dt = x.dtype
        qkv = F.linear(x, self.attn.qkv.weight.to(dt), bt.qkv_bias)
        attend = (cosine_window_attention if dt == torch.bfloat16
                  else cosine_window_attention_reference)
        with span("fuxi.block.attention"):
            o = attend(qkv, bt.scale, bt.bias, order, inverse, labels)
        x = x + layer_norm(F.linear(o, self.attn.proj.weight.to(dt), self.attn.proj.bias.to(dt)),
                           self.norm1)
        w1, b1, w2, b2 = self.mlp.weights(dt)
        return x + layer_norm(F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2), self.norm2)


class FuxiModel(nn.Module):
    """FuXi's network. Parameters are ``param_dtype`` (f32) until
    :meth:`freeze`; activations run in ``cfg.compute_dtype``. ``forward``
    takes the two physical states and returns the next, physical, f32."""

    #: the states a step takes: ``rollout.make_forecast_step`` gives such a
    #: model the step ``(x_prev, x_cur) -> (x_cur, x_next)``
    input_states = 2

    def __init__(self, cfg: FuxiConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.embed = CubeEmbedding(cfg)
        self.down = DownBlock(cfg.dim, cfg.groups)
        self.blocks = nn.ModuleList(SwinV2Block(cfg) for _ in range(cfg.depth))
        self.up = UpBlock(cfg.dim, cfg.groups)
        self.head = nn.Linear(cfg.dim, cfg.variables * cfg.cube[1] * cfg.cube[2])
        self._frozen: Optional[Tables] = None

    def tables(self) -> Tables:
        """The window orders, the shift's labels and every block's tables,
        from the weights as they are."""
        cfg, dev, dt = self.cfg, self.head.weight.device, self.compute_dtype
        h, w = cfg.tokens
        order = tuple(window_order(h, w, cfg.window, s).to(dev, torch.int32)
                      for s in (False, True))
        inverse = tuple(torch.argsort(o) for o in order)
        labels = shift_labels(h, w, cfg.window).to(dev)
        return Tables(order, inverse, labels, [b.attn.tables(cfg.window, dt)
                                               for b in self.blocks])

    def freeze(self) -> None:
        """Cast the weights of the products and the LayerNorms to the
        compute dtype, in place and once (the convolutions' channels-last),
        and keep :meth:`tables`. The f32 masters are not kept: a frozen
        model serves forecasts only. A second call does nothing."""
        if self._frozen is not None:
            return
        self._frozen = self.tables()
        self.requires_grad_(False)
        dt = self.compute_dtype
        for name, mod in self.named_modules():
            if "cpb_mlp" in name or not isinstance(
                    mod, (nn.Linear, nn.LayerNorm, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
                continue
            for p in mod.parameters(recurse=False):
                fmt = torch.channels_last if p.dim() == 4 else torch.contiguous_format
                p.data = p.data.to(dt).contiguous(memory_format=fmt)

    def forward(self, x_prev: torch.Tensor, x_cur: torch.Tensor,
                k: FuxiConstants) -> torch.Tensor:
        """Physical (B, V, lat, lon) at t - 6 h and t -> physical at t + 6 h, f32."""
        cfg, dt = self.cfg, self.compute_dtype
        t = self._frozen if self._frozen is not None else self.tables()
        with span("fuxi.embed"):
            x = self.embed((x_prev, x_cur), k, cfg.grid, dt)
        with span("fuxi.down"):
            x = self.down(x)
        skip = x
        for i, block in enumerate(self.blocks):
            s = i % 2
            with span("fuxi.block"):
                x = block(x, t.blocks[i], t.order[s], t.inverse[s], t.labels if s else None)
        with span("fuxi.up"):
            x = self.up(torch.cat([skip, x], dim=-1))
        with span("fuxi.head"):
            return self._head(x, k)

    def _head(self, x: torch.Tensor, k: FuxiConstants) -> torch.Tensor:
        """Linear to V x 4 x 4 a token, pixel-shuffled to (lat - 1) x lon in
        f32, bilinear to lat x lon (the next state normalized), then back to
        physical units."""
        cfg = self.cfg
        b, h, w, _ = x.shape
        v, (_, kh, kw) = cfg.variables, cfg.cube
        y = F.linear(x, self.head.weight.to(x.dtype), self.head.bias.to(x.dtype))
        full = torch.empty((b, v, h * kh, w * kw), dtype=torch.float32, device=x.device)
        full.view(b, v, h, kh, w, kw).copy_(y.view(b, h, w, v, kh, kw).permute(0, 3, 1, 4, 2, 5))
        out = F.interpolate(full, size=(cfg.lat, cfg.lon), mode="bilinear", align_corners=False)
        return torch.addcmul(k.mean, out, k.std)

