"""Aurora (Bodnar et al. 2024, "Aurora: A Foundation Model of the Atmosphere",
arXiv:2405.13063, supplementary section B) in PyTorch: the 1.3 B-parameter
pretrained 0.25-degree model.

One step maps two states (t - 6 h, t), each the upper fields (B, 5, 13, lat,
lon) and the surface fields (B, 4, lat, lon), and the clock (hours since
1970 at t, (B,)) to the state at t + 6 h::

    3D Perceiver encoder   every variable's (2, 4, 4) patch embedded to D and
                           summed over the variables (a level's 5 upper ones,
                           or the 4 surface and 3 static ones, then a
                           LayerNorm); a pressure encoding added to each
                           level; cross-attention from 3 learned latents to
                           the patch's 13 levels; the surface as latent level
                           0; the position, area, lead-time and absolute-time
                           encodings added to every token
    3D Swin U-Net          (level, lat, lon) windows (2, 6, 12), shifted every
                           other block (longitude wraps); encoder stages of
                           (6, 10, 8) blocks at C = D, 2D, 4D, patch merging
                           between them; decoder stages of (8, 10, 6) blocks
                           at 4D, 2D, D, patch splitting between them, each
                           split stream plus the encoder's skip; the last
                           output concatenated with the first stage's (2D)
    3D Perceiver decoder   queries from the 13 output pressures cross-attend
                           to the patch's 3 atmospheric latents; a linear head
                           per variable back to its 4x4 pixels (the surface
                           from latent level 0): the next state, normalized

A block is res-post-norm with an adaptive LayerNorm conditioned on the lead
time: ``x = x + AdaLN1(attn(x), c)``, ``x = x + AdaLN2(mlp(x), c)``,
``AdaLN(y, c) = LN(y) (1 + scale) + shift`` with ``(shift, scale) =
Linear(SiLU(c))`` and ``c = Linear(SiLU(Linear(F(lead hours))))``. The
attention is ``softmax(q k^T / sqrt(d) + mask) v`` with no position bias;
the shift mask separates Swin's regions on the level and latitude axes, and
longitude wraps unmasked. A stage whose grid the window does not tile (the
bottom one, 4 x 45 x 90) is zero-padded at both ends of latitude and
longitude for the attention and cropped after it; pad tokens are keys like
any other. ``F(x)`` is the sin and cos of ``2 pi x / lambda`` over
log-spaced wavelengths between two bounds (``ENCODING_BOUNDS``).

Where the paper is silent the model takes the values that
``benchmark/configs/aurora_pretrained_bf16.json`` lists under ``assumed``.

Numerics in ``compute_dtype`` bf16: products in bf16 with f32 accumulation
(cuBLAS for the blocks and the Perceivers, ``scaled_dot_product_attention``
for the attentions, the port's Dense operator through ``DownSample`` and
``UpSample``); LayerNorm statistics, the softmax and the Fourier encodings
in f32; the state in f32 and physical units. :meth:`AuroraModel.freeze`
computes what depends on the weights and the configuration alone once
(:class:`Tables`: the encodings but the absolute time's, both Perceivers'
queries, every AdaLN's affine, since the lead time is the same on every
step, and the shift masks), then casts the weights to the compute dtype in
place. Under a running profiler the step is ``aurora.encode``, one
``aurora.block`` per block holding one ``aurora.block.attention``
(everything between the qkv and the output projections), four
``aurora.resample`` and ``aurora.decode`` (``utils.profiling.span``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pangu_tpu_torch import dtype_of
from pangu_tpu_torch.model.blocks import DownSample, Mlp, UpSample
from pangu_tpu_torch.model.fuxi import layer_norm
from pangu_tpu_torch.ops.windows import window_partition
from pangu_tpu_torch.utils.profiling import span

#: the shift mask's value between regions (Swin's)
MASKED = -100.0
#: the Earth's radius, km (the patch areas)
EARTH_RADIUS_KM = 6371.0
#: (lower, upper) wavelength of each Fourier encoding: hours, hours since
#: 1970, hPa, degrees and km^2
ENCODING_BOUNDS = {"lead": (1.0 / 60.0, 168.0), "time": (1.0, 8766.0), "pressure": (0.01, 1e5),
                   "position": (0.01, 720.0), "area": (1.0, 1e5)}
#: Aurora's 13 pressure levels, hPa
PRESSURES = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)


@dataclass(frozen=True)
class AuroraConfig:
    """The network's widths and grid. Defaults are the pretrained 0.25-degree
    model's (``aurora_pretrained``)."""

    lat: int = 720
    lon: int = 1440
    pressures: Tuple[int, ...] = PRESSURES
    upper_vars: int = 5
    surface_vars: int = 4
    static_vars: int = 3
    history: int = 2
    patch: int = 4
    dim: int = 512
    encoder_depths: Tuple[int, ...] = (6, 10, 8)
    encoder_heads: Tuple[int, ...] = (8, 16, 32)
    decoder_depths: Tuple[int, ...] = (8, 10, 6)
    decoder_heads: Tuple[int, ...] = (32, 16, 8)
    window: Tuple[int, int, int] = (2, 6, 12)  # (level, lat, lon) tokens
    latent_levels: int = 3
    mlp_ratio: int = 4
    decoder_mlp_ratio: int = 2
    perceiver_heads: int = 16
    perceiver_head_dim: int = 64
    lead_hours: float = 6.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        stages = len(self.encoder_depths)
        if not (len(self.encoder_heads) == len(self.decoder_depths) == len(self.decoder_heads)
                == stages):
            raise ValueError("the encoder and the decoder need a depth and heads per stage")
        if self.lat % self.patch or self.lon % self.patch:
            raise ValueError(f"the {self.lat}x{self.lon} grid must tile into "
                             f"{self.patch}x{self.patch} patches")
        h, w = self.lat // self.patch, self.lon // self.patch
        if h % 2 ** (stages - 1) or w % 2 ** (stages - 1):
            raise ValueError(f"the {h}x{w} patch grid must halve {stages - 1} times")
        if self.levels_z % self.window[0]:
            raise ValueError(f"the {self.levels_z} latent levels must tile into level windows "
                             f"of {self.window[0]}")
        for c, heads in zip(self.widths, self.encoder_heads):
            if c % heads:
                raise ValueError(f"C {c} must divide into {heads} heads")
        if self.param_dtype != "float32":
            raise ValueError("the parameters are f32 masters; the step casts them once")

    @property
    def levels(self) -> int:
        return len(self.pressures)

    @property
    def levels_z(self) -> int:
        """The backbone's level axis: the surface and the atmospheric latents."""
        return self.latent_levels + 1

    @property
    def widths(self) -> Tuple[int, ...]:
        """C of each encoder stage."""
        return tuple(self.dim * 2 ** i for i in range(len(self.encoder_depths)))

    @property
    def grids(self) -> List[Tuple[int, int, int]]:
        """(levels, rows, columns) of each encoder stage's token grid."""
        h, w = self.lat // self.patch, self.lon // self.patch
        return [(self.levels_z, h >> i, w >> i) for i in range(len(self.encoder_depths))]


def aurora_pretrained() -> AuroraConfig:
    """Aurora 0.25-degree pretrained at its published widths."""
    return AuroraConfig()


def aurora_tiny(**kw) -> AuroraConfig:
    """A CPU size with every branch of the real one: three stages on a
    12x24 patch grid with the real (2, 6, 12) windows, so the first two
    stages tile and the bottom one (3x6) is padded in both latitude and
    longitude; shifted and unshifted blocks in every stage; f32."""
    defaults = dict(lat=48, lon=96, pressures=(100, 250, 500, 850, 1000), dim=32,
                    encoder_depths=(2, 2, 2), encoder_heads=(4, 8, 16), decoder_depths=(2, 2, 2),
                    decoder_heads=(16, 8, 4), perceiver_heads=4, perceiver_head_dim=8,
                    compute_dtype="float32")
    defaults.update(kw)
    return AuroraConfig(**defaults)


@dataclass
class AuroraConstants:
    """The normalization statistics of the state's variables and the static
    fields, f32: ``upper_mean``/``upper_std`` (1, 5, levels, 1, 1),
    ``surface_mean``/``surface_std`` (1, 4, 1, 1) and ``static`` (3, lat,
    lon) in normalized units."""

    upper_mean: torch.Tensor
    upper_std: torch.Tensor
    surface_mean: torch.Tensor
    surface_std: torch.Tensor
    static: torch.Tensor


# ---- encodings and geometry -------------------------------------------------------------


def fourier(x: torch.Tensor, dim: int, bounds: Tuple[float, float]) -> torch.Tensor:
    """(..., dim) f32: ``sin(x w)`` then ``cos(x w)`` for ``dim / 2``
    wavelengths log-spaced over ``bounds``, ``w = 2 pi / wavelength`` rounded
    once from f64 to f32, the phase one f32 product."""
    lo, hi = bounds
    lam = torch.logspace(math.log10(lo), math.log10(hi), dim // 2, dtype=torch.float64)
    omega = (2 * math.pi / lam).to(torch.float32).to(x.device)
    phase = x.float()[..., None] * omega
    return torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)


def patch_geometry(cfg: AuroraConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 (rows, columns) of each patch: its centre's latitude + 90 and
    longitude, in degrees, and its area, km^2. Rows of the grid lie at
    ``90 - i 180 / lat`` (the 0.25-degree grid without its -90 row),
    columns at ``j 360 / lon``."""
    p, h, w = cfg.patch, cfg.lat // cfg.patch, cfg.lon // cfg.patch
    dlat, dlon = 180.0 / cfg.lat, 360.0 / cfg.lon
    lat = 90.0 - dlat * (torch.arange(h, dtype=torch.float64) * p + (p - 1) / 2)
    lon = dlon * (torch.arange(w, dtype=torch.float64) * p + (p - 1) / 2)
    top = torch.clamp(lat + p * dlat / 2, max=90.0)
    bottom = torch.clamp(lat - p * dlat / 2, min=-90.0)
    band = torch.sin(torch.deg2rad(top)) - torch.sin(torch.deg2rad(bottom))
    area = EARTH_RADIUS_KM ** 2 * math.radians(p * dlon) * band
    rows = (lat + 90.0)[:, None].expand(h, w)
    cols = lon[None, :].expand(h, w)
    return rows.float(), cols.float(), area[:, None].expand(h, w).float()


def window_pads(grid: Tuple[int, int, int], window: Tuple[int, int, int]
                ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) zero rows and columns that make the
    window tile a stage's grid, split between both ends (the larger half
    at the end)."""
    out = []
    for n, k in zip(grid[1:], window[1:]):
        extra = -n % k
        out.append((extra // 2, extra - extra // 2))
    return tuple(out)


def shift_mask(grid: Tuple[int, int, int], window: Tuple[int, int, int]) -> torch.Tensor:
    """(nW, 1, T, T) f32 of a padded grid in ``ops.windows.window_partition``'s
    window order (longitude windows, then level and latitude windows) of one
    sample: ``MASKED`` between tokens of different regions of the rolled
    grid, 0 within one. A token's region is ``3 * level region + latitude
    region``, a region of an axis of n positions ``0`` below ``n - window``,
    ``1`` below ``n - shift``, else ``2`` (Swin's slices); longitude wraps
    and has one region."""
    z, h, w = grid

    def region(n, k):
        i = torch.arange(n)
        return (i >= n - k).long() + (i >= n - k // 2).long()

    label = (3 * region(z, window[0])[:, None] + region(h, window[1])[None, :])[:, :, None]
    t = window[0] * window[1] * window[2]
    lab = window_partition(label.expand(z, h, w).reshape(1, *grid, 1), window).reshape(-1, t)
    return torch.where(lab[:, :, None] != lab[:, None, :], MASKED, 0.0)[:, None]


class StageGeometry(NamedTuple):
    """One stage: its grid (Z, H, W), the pad that the window needs
    (:func:`window_pads`), the window and its shift."""

    grid: Tuple[int, int, int]
    pads: Tuple[Tuple[int, int], Tuple[int, int]]
    window: Tuple[int, int, int]

    @property
    def padded(self) -> Tuple[int, int, int]:
        z, h, w = self.grid
        (t, b), (l, r) = self.pads
        return z, h + t + b, w + l + r

    @property
    def shift(self) -> Tuple[int, int, int]:
        return tuple(k // 2 for k in self.window)


def window_order(geo: StageGeometry, shifted: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gather, scatter) int64 of one sample: ``gather`` (Z Hp Wp,) holds, at
    each place of the padded (and, when ``shifted``, rolled) grid's windows
    in ``ops.windows.window_partition``'s order, the row of the grid's
    token there, its index in the (Z, H, W) grid, or Z H W for a pad token;
    ``scatter`` (Z H W,) the place of each token. One gather each way is
    then the pad, the roll, the partition and their inverses."""
    z, h, w = geo.grid
    zp, hp, wp = geo.padded
    (t, _), (l, _) = geo.pads
    n = z * h * w
    idx = torch.full((zp, hp, wp), n, dtype=torch.long)
    idx[:, t:t + h, l:l + w] = torch.arange(n).view(z, h, w)
    if shifted:
        idx = torch.roll(idx, [-s for s in geo.shift], dims=(0, 1, 2))
    gather = window_partition(idx.view(1, zp, hp, wp, 1), geo.window).reshape(-1)
    real = gather < n
    scatter = torch.empty(n, dtype=torch.long)
    scatter[gather[real]] = torch.nonzero(real).squeeze(1)
    return gather, scatter


def window_attention(qkv: torch.Tensor, pad_value: torch.Tensor, heads: int,
                     geo: StageGeometry, order: Tuple[torch.Tensor, torch.Tensor],
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The windows' attention of qkv (B, Z, H, W, 3C) -> (B, Z, H, W, C):
    the windows of the padded (``pad_value``, the qkv of a zero token) and,
    on a shifted block (``mask`` given, (nW, 1, T, T) of one sample),
    rolled grid gathered by ``order`` (:func:`window_order`),
    ``scaled_dot_product_attention``, and the tokens gathered back."""
    gather, scatter = order
    b, c3 = qkv.shape[0], qkv.shape[-1]
    src = qkv.reshape(b, -1, c3)
    if any(sum(p) for p in geo.pads):
        src = torch.cat([src, pad_value.to(qkv.dtype).view(1, 1, c3).expand(b, 1, c3)], dim=1)
    tok = geo.window[0] * geo.window[1] * geo.window[2]
    c = c3 // 3
    win = src.index_select(1, gather).view(-1, tok, 3, heads, c // heads)
    q, k, v = win.permute(2, 0, 3, 1, 4).unbind(0)
    if mask is not None:
        mask = mask.to(q.dtype)
        mask = mask if b == 1 else mask.repeat(b, 1, 1, 1)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    o = o.transpose(1, 2).reshape(b, -1, c)
    return o.index_select(1, scatter).view(*qkv.shape[:-1], c)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` in x's dtype (cuBLAS on the card)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def kv_heads(kv: torch.Tensor, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv (B, n, P, 2 heads d) of n context tokens at each of P patches ->
    k, v (B P, heads, n, d)."""
    b, n, p, c2 = kv.shape
    d = c2 // (2 * heads)
    k, v = kv.view(b, n, p, 2, heads, d).permute(3, 0, 2, 4, 1, 5).unbind(0)
    return k.reshape(b * p, heads, n, d), v.reshape(b * p, heads, n, d)


# ---- layers -----------------------------------------------------------------------------


class AdaLN(nn.Module):
    """``LN(y) (1 + scale) + shift``, LN without an affine, eps 1e-5, with
    ``(shift, scale) = modulation(SiLU(c))``."""

    def __init__(self, dim: int, context: int):
        super().__init__()
        self.modulation = nn.Linear(context, 2 * dim)

    def affine(self, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(1 + scale, shift), f32, from the conditioning ``c`` (..., context)."""
        shift, scale = F.linear(F.silu(c.float()), self.modulation.weight.float(),
                                self.modulation.bias.float()).chunk(2, dim=-1)
        return 1.0 + scale, shift


def ada_layer_norm(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(y, y.shape[-1:], weight, bias, 1e-5)


class PerceiverLayer(nn.Module):
    """One cross-attention layer: ``latents + LN(attn(latents, context))``,
    then ``+ LN(mlp(.))``; q, kv and out without biases."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_ratio: int):
        super().__init__()
        self.heads = heads
        inner = heads * head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.norm1 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, mlp_ratio)
        self.norm2 = nn.LayerNorm(dim)

    def query(self, latents: torch.Tensor) -> torch.Tensor:
        """(1, heads, n, d) of the (n, dim) latents, the same at every patch."""
        q = F.linear(latents, self.to_q.weight.to(latents.dtype))
        return q.view(1, latents.shape[0], self.heads, -1).transpose(1, 2)

    def forward(self, latents: torch.Tensor, q: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """``latents`` (n, dim), ``q`` its :meth:`query`, ``context`` (B, m,
        P, dim): m tokens at each of P patches -> (B P, n, dim)."""
        k, v = kv_heads(linear(context, self.to_kv), self.heads)
        o = F.scaled_dot_product_attention(q.expand(k.shape[0], -1, -1, -1), k, v)
        o = o.transpose(1, 2).flatten(2)
        x = latents + layer_norm(linear(o, self.to_out), self.norm1)
        w1, b1, w2, b2 = self.mlp.weights(x.dtype)
        return x + layer_norm(F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2), self.norm2)


class AuroraBlock(nn.Module):
    """One res-post-norm 3D Swin block with AdaLN on the grid (B, Z, H, W, C)."""

    def __init__(self, dim: int, heads: int, context: int, mlp_ratio: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm1 = AdaLN(dim, context)
        self.mlp = Mlp(dim, mlp_ratio)
        self.norm2 = AdaLN(dim, context)

    def forward(self, x: torch.Tensor, ada: Tuple[torch.Tensor, ...], geo: StageGeometry,
                order: Tuple[torch.Tensor, torch.Tensor],
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """``ada`` the two AdaLNs' (weight, bias) in x's dtype, ``order`` the
        stage's :func:`window_order` for this block's shift, ``mask`` the
        stage's shift mask on a shifted block, else None."""
        dt = x.dtype
        qkv = linear(x, self.qkv)
        with span("aurora.block.attention"):
            o = window_attention(qkv, self.qkv.bias.to(dt), self.heads, geo, order, mask)
        x = x + ada_layer_norm(linear(o, self.proj), ada[0], ada[1])
        w1, b1, w2, b2 = self.mlp.weights(dt)
        return x + ada_layer_norm(F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2), ada[2], ada[3])


class Encoder(nn.Module):
    """The 3D Perceiver encoder's parameters."""

    def __init__(self, cfg: AuroraConfig):
        super().__init__()
        d, patch = cfg.dim, cfg.history * cfg.patch * cfg.patch
        self.surf_embed = nn.Linear((cfg.surface_vars + cfg.static_vars) * patch, d)
        self.surf_norm = nn.LayerNorm(d)
        self.atmos_embed = nn.Linear(cfg.upper_vars * patch, d)
        self.level_embed = nn.Linear(d, d)
        self.latents = nn.Parameter(torch.zeros(cfg.latent_levels, d))
        self.perceiver = PerceiverLayer(d, cfg.perceiver_heads, cfg.perceiver_head_dim,
                                        cfg.mlp_ratio)
        self.pos_embed = nn.Linear(d, d)
        self.area_embed = nn.Linear(d, d)
        self.lead_embed = nn.Linear(d, d)
        self.time_embed = nn.Linear(d, d)


class Decoder(nn.Module):
    """The 3D Perceiver decoder's parameters, at 2D."""

    def __init__(self, cfg: AuroraConfig):
        super().__init__()
        d, pp = 2 * cfg.dim, cfg.patch * cfg.patch
        self.level_embed = nn.Linear(d, d)
        self.perceiver = PerceiverLayer(d, cfg.perceiver_heads, cfg.perceiver_head_dim,
                                        cfg.decoder_mlp_ratio)
        self.atmos_head = nn.Linear(d, cfg.upper_vars * pp)
        self.surf_head = nn.Linear(d, cfg.surface_vars * pp)


def _stage(depth: int, dim: int, heads: int, cfg: AuroraConfig) -> nn.ModuleList:
    return nn.ModuleList(AuroraBlock(dim, heads, cfg.dim, cfg.mlp_ratio) for _ in range(depth))


class Backbone(nn.Module):
    """The 3D Swin U-Net's parameters: the lead time's MLP, the stages and the
    resamplers (``model.blocks``' ``DownSample`` and ``UpSample``)."""

    def __init__(self, cfg: AuroraConfig):
        super().__init__()
        d, widths, grids = cfg.dim, cfg.widths, cfg.grids
        self.time_mlp = nn.Sequential(nn.Linear(d, d), nn.SiLU(), nn.Linear(d, d))
        self.encoder = nn.ModuleList(_stage(n, c, h, cfg) for n, c, h in
                                     zip(cfg.encoder_depths, widths, cfg.encoder_heads))
        self.down = nn.ModuleList(DownSample(c, 0) for c in widths[:-1])
        self.decoder = nn.ModuleList(_stage(n, c, h, cfg) for n, c, h in
                                     zip(cfg.decoder_depths, widths[::-1], cfg.decoder_heads))
        self.up = nn.ModuleList(UpSample(c, c // 2, g[1]) for c, g in
                                zip(widths[:0:-1], grids[-2::-1]))


class Tables(NamedTuple):
    """What a step reads beside the weights and the state, all in the compute
    dtype: the pressure encodings of the encoder (levels, D), its latents
    and their query, the position, area and lead-time encodings summed (h, w, D),
    the decoder's queries (levels, 2D) and their query, each block's AdaLN
    (weight, bias, weight, bias) (encoder stages, then decoder stages), and
    each stage's window orders, unshifted and shifted (:func:`window_order`),
    and shift mask (:func:`shift_mask`)."""

    levels: torch.Tensor
    latents: torch.Tensor
    enc_q: torch.Tensor
    static_enc: torch.Tensor
    queries: torch.Tensor
    dec_q: torch.Tensor
    ada: List[Tuple[torch.Tensor, ...]]
    orders: List[Tuple[Tuple[torch.Tensor, torch.Tensor], ...]]
    masks: List[torch.Tensor]


class AuroraModel(nn.Module):
    """Aurora's network. Parameters are ``param_dtype`` (f32) until
    :meth:`freeze`; activations run in ``cfg.compute_dtype``. ``forward``
    takes the two physical states and the clock and returns the next
    physical state, f32."""

    #: ``rollout.make_forecast_step`` gives a model that takes two states and
    #: a clock the step ``(u_prev, s_prev, u, s, hours) -> (u, s, u', s',
    #: hours + lead_hours)``
    input_states = 2

    def __init__(self, cfg: AuroraConfig):
        super().__init__()
        self.cfg = cfg
        self.lead_hours = float(cfg.lead_hours)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.encoder = Encoder(cfg)
        self.backbone = Backbone(cfg)
        self.decoder = Decoder(cfg)
        self.geometry = [StageGeometry(g, window_pads(g, cfg.window), cfg.window)
                         for g in cfg.grids]
        self._frozen: Optional[Tables] = None

    def blocks(self) -> List[AuroraBlock]:
        """Every block in the order of a step."""
        return [b for stage in list(self.backbone.encoder) + list(self.backbone.decoder)
                for b in stage]

    @torch.no_grad()
    def tables(self) -> Tables:
        """:class:`Tables` from the weights as they are, computed in f32."""
        cfg, enc, dec, dt = self.cfg, self.encoder, self.decoder, self.compute_dtype
        dev = enc.latents.device
        d = cfg.dim
        pressures = torch.tensor(cfg.pressures, dtype=torch.float32, device=dev)

        def lin(layer, x):
            return F.linear(x, layer.weight.float(), layer.bias.float())

        levels = lin(enc.level_embed, fourier(pressures, d, ENCODING_BOUNDS["pressure"]))
        rows, cols, area = (t.to(dev) for t in patch_geometry(cfg))
        pos = torch.cat([fourier(rows, d // 2, ENCODING_BOUNDS["position"]),
                         fourier(cols, d // 2, ENCODING_BOUNDS["position"])], dim=-1)
        lead = fourier(torch.tensor(self.lead_hours, device=dev), d, ENCODING_BOUNDS["lead"])
        static_enc = (lin(enc.pos_embed, pos) + lin(enc.area_embed, fourier(
            area, d, ENCODING_BOUNDS["area"])) + lin(enc.lead_embed, lead))
        queries = lin(dec.level_embed, fourier(pressures, 2 * d, ENCODING_BOUNDS["pressure"]))
        mlp = self.backbone.time_mlp
        c = lin(mlp[2], F.silu(lin(mlp[0], lead)))
        ada = [tuple(t.to(dt) for n in (b.norm1, b.norm2) for t in n.affine(c))
               for b in self.blocks()]
        orders = [tuple(tuple(t.to(dev) for t in window_order(g, s)) for s in (False, True))
                  for g in self.geometry]
        masks = [shift_mask(g.padded, g.window).to(dev, dt) for g in self.geometry]
        return Tables(levels.to(dt), enc.latents.to(dt),
                      enc.perceiver.query(enc.latents.float()).to(dt),
                      static_enc.to(dt), queries.to(dt),
                      dec.perceiver.query(queries).to(dt), ada, orders, masks)

    def freeze(self) -> None:
        """Keep :meth:`tables` and cast the weights of the products and the
        LayerNorms to the compute dtype, in place and once. The f32 masters
        are not kept: a frozen model serves forecasts only. A second call
        does nothing."""
        if self._frozen is not None:
            return
        self._frozen = self.tables()
        self.requires_grad_(False)
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.LayerNorm)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(self.compute_dtype)

    def forward(self, upper_prev: torch.Tensor, surface_prev: torch.Tensor,
                upper: torch.Tensor, surface: torch.Tensor, hours: torch.Tensor,
                k: AuroraConstants) -> Tuple[torch.Tensor, torch.Tensor]:
        """Physical states at t - 6 h and t, and the clock at t (hours since
        1970, (B,) f32) -> the physical state at t + 6 h, f32."""
        t = self._frozen if self._frozen is not None else self.tables()
        with span("aurora.encode"):
            x = self._encode((upper_prev, upper), (surface_prev, surface), hours, k, t)
        x = self._backbone(x, t)
        with span("aurora.decode"):
            return self._decode(x, k, t)

    def _encode(self, uppers, surfaces, hours, k: AuroraConstants, t: Tables) -> torch.Tensor:
        """-> (B, Z, h, w, D): the surface token, then the atmospheric latents."""
        cfg, enc, dt = self.cfg, self.encoder, self.compute_dtype
        b, p = uppers[0].shape[0], cfg.patch
        h, w = cfg.lat // p, cfg.lon // p
        nt, vu, vs, levels = cfg.history, cfg.upper_vars, cfg.surface_vars, cfg.levels
        up = uppers[0].new_empty((b, levels, h, w, vu, nt, p, p), dtype=dt)
        sf = uppers[0].new_empty((b, h, w, vs + cfg.static_vars, nt, p, p), dtype=dt)
        u_inv, s_inv = 1.0 / k.upper_std, 1.0 / k.surface_std
        for i, (u, s) in enumerate(zip(uppers, surfaces)):
            n = torch.addcmul(-k.upper_mean * u_inv, u, u_inv)
            up[..., i, :, :].copy_(n.view(b, vu, levels, h, p, w, p).permute(0, 2, 3, 5, 1, 4, 6))
            n = torch.addcmul(-k.surface_mean * s_inv, s, s_inv)
            sf[:, :, :, :vs, i].copy_(n.view(b, vs, h, p, w, p).permute(0, 2, 4, 1, 3, 5))
        static = k.static.view(-1, h, p, w, p).permute(1, 3, 0, 2, 4)
        sf[:, :, :, vs:].copy_(static[None, :, :, :, None].expand(b, h, w, -1, nt, p, p))
        atmos = linear(up.view(b, levels, h * w, -1), enc.atmos_embed)
        atmos += t.levels[None, :, None]
        lat = enc.perceiver(t.latents, t.enc_q, atmos)
        surf = layer_norm(linear(sf.view(b, h, w, -1), enc.surf_embed), enc.surf_norm)
        x = torch.cat([surf[:, None], lat.view(b, h, w, -1, cfg.dim).permute(0, 3, 1, 2, 4)], 1)
        clock = linear(fourier(hours, cfg.dim, ENCODING_BOUNDS["time"]).to(dt), enc.time_embed)
        return x.add_(t.static_enc).add_(clock.view(b, 1, 1, 1, -1))

    def _backbone(self, x: torch.Tensor, t: Tables) -> torch.Tensor:
        """The U-Net: -> (B, Z, h, w, 2D)."""
        bb, ada = self.backbone, iter(t.ada)
        n = len(self.geometry)

        def stage(x, blocks, s):
            for i, block in enumerate(blocks):
                with span("aurora.block"):
                    x = block(x, next(ada), self.geometry[s], t.orders[s][i % 2],
                              t.masks[s] if i % 2 else None)
            return x

        skips = []
        for s, blocks in enumerate(bb.encoder):
            x = stage(x, blocks, s)
            if s < n - 1:
                skips.append(x)
                with span("aurora.resample"):
                    x = bb.down[s](x)
        for i, blocks in enumerate(bb.decoder):
            x = stage(x, blocks, n - 1 - i)
            if i < n - 1:
                with span("aurora.resample"):
                    x = bb.up[i](x)
                x = x + skips[n - 2 - i]
        return torch.cat([x, skips[0]], dim=-1)

    def _decode(self, x: torch.Tensor, k: AuroraConstants,
                t: Tables) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decoder Perceiver and the heads, unpatchified and put back in
        physical units."""
        cfg, dec = self.cfg, self.decoder
        b, _, h, w, _ = x.shape
        p, vu, vs, levels = cfg.patch, cfg.upper_vars, cfg.surface_vars, cfg.levels
        lat = dec.perceiver(t.queries, t.dec_q, x[:, 1:].reshape(b, cfg.latent_levels, h * w, -1))
        atmos = linear(lat, dec.atmos_head).view(b, h, w, levels, vu, p, p)
        surf = linear(x[:, 0], dec.surf_head).view(b, h, w, vs, p, p)
        upper = torch.empty((b, vu, levels, h * p, w * p), dtype=torch.float32, device=x.device)
        upper.view(b, vu, levels, h, p, w, p).copy_(atmos.permute(0, 4, 3, 1, 5, 2, 6))
        surface = torch.empty((b, vs, h * p, w * p), dtype=torch.float32, device=x.device)
        surface.view(b, vs, h, p, w, p).copy_(surf.permute(0, 3, 1, 4, 2, 5))
        return (torch.addcmul(k.upper_mean, upper, k.upper_std),
                torch.addcmul(k.surface_mean, surface, k.surface_std))
