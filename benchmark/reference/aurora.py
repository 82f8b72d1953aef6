"""Aurora (Bodnar et al. 2024, arXiv:2405.13063, supplementary section B, and
the public ``microsoft/aurora`` code's ``AuroraPretrained``) in plain
PyTorch, as a function of a state dict: the 0.25-degree pretrained model's
step from two states and the clock to the next state, normalized.

The step, in the public code's order:

- normalize both states; cut every variable into (2, 4, 4) patches (two
  history steps, 4x4 pixels); embed a level's 5 upper variables with one
  Linear (the sum of a Linear per variable), the 4 surface and 3 static
  fields (the static ones repeated over the two steps) with another,
  followed by a LayerNorm;
- add ``Linear(F(pressure))`` to each of the 13 levels; a Perceiver layer
  from 3 learned latents to the patch's 13 level tokens (16 heads of 64,
  q, kv and out without biases, ``latents + LN(attn)``, then ``+
  LN(mlp)``, MLP ratio 4); the surface token is latent level 0;
- add ``Linear(F(.))`` of the patch centre's latitude + 90 and longitude
  (half the channels each), of its area, of the lead time and of the
  absolute time to every token;
- the 3D Swin U-Net over (level, lat, lon): windows (2, 6, 12), every
  other block shifted by (1, 3, 6) with Swin's region mask (-100) on the
  level and latitude axes and longitude wrapping unmasked; a grid the
  window does not tile (45 x 90 at the bottom) zero-padded at both ends
  (the larger half at the end) before the roll and cropped after the roll
  back; encoder stages of (6, 10, 8) blocks at C = 512, 1024, 2048, Swin's
  patch merging (2x2 space-to-depth in (lat offset, lon offset, C) order,
  LayerNorm, Linear 4C -> 2C without bias) between them; decoder stages of
  (8, 10, 6) blocks, patch splitting (Linear C -> 2C without bias, 2x2
  depth-to-space, LayerNorm, Linear without bias) between them and the
  matching encoder stage's output added after it; the last output
  concatenated with the first stage's, to 2D = 1024;
- a block: ``x = x + AdaLN1(attn(x), c)``, ``x = x + AdaLN2(mlp(x), c)``
  with ``AdaLN(y, c) = LN(y) (1 + scale) + shift`` (LN without affine, eps
  1e-5), ``(shift, scale) = Linear(SiLU(c))``, ``c =
  Linear(SiLU(Linear(F(lead hours))))``; the attention ``softmax(q k^T / 8
  + mask) v`` with biases on qkv and the projection and no position bias;
  the MLP Linear(4C), exact GELU, Linear;
- the decoder Perceiver at 2D: queries ``Linear(F(pressure))`` of the 13
  output levels cross-attend to the patch's 3 atmospheric latents (MLP
  ratio 2); a Linear per upper variable to its 4x4 pixels, and per surface
  variable on latent level 0; unpatchified, the next state normalized.

``F(x)`` is ``sin(x w)`` and ``cos(x w)`` (that order), ``w = 2 pi / l``
rounded from f64 to f32, for half the width's wavelengths ``l``
log-spaced between the bounds of ``BOUNDS``. The grid's rows lie at ``90 -
i 180 / lat`` (the 721-row grid without its -90 row), its columns at ``j
360 / lon``; a patch's area is ``R^2 dlon (sin top - sin bottom)`` with R
= 6371 km. The clock is f32 hours since 1970.

Values the paper leaves open, assumed here as in the configuration file's
``assumed``: the encodings' bounds and forms above, the pad split, the
Perceivers as one layer each, the embeddings' and heads' layouts, the
static fields in normalized units, the lead time of 6 h.

Departures: the public code pads the grid with zero tokens before the qkv
product; here the qkv of the real tokens is padded with the qkv bias,
which is the qkv of a zero token, so the numbers are the same and no
product of zeros is made. The public code runs only the backbone in bf16;
this reference is f32 throughout. The program computes the same
mathematics in another order (its windows through
``scaled_dot_product_attention``, its embeddings and constant encodings
once per model), which moves only the rounding.

Every product runs through ``linear`` and ``bmm``, which compute in
``precision``: "f32" (float32, TF32 off, which ``forward`` sees to), or a
control that rounds each product's operands to a lower precision first
("tf32": a 10-bit mantissa; "fp8": float8 e4m3 with one scale per tensor).
The model is forecast-only: no backward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32", "fp8")
_FP8_MAX = 448.0
BOUNDS = {"lead": (1.0 / 60.0, 168.0), "time": (1.0, 8766.0), "pressure": (0.01, 1e5),
          "position": (0.01, 720.0), "area": (1.0, 1e5)}
RADIUS_KM = 6371.0


def quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) rounded to ``precision`` and back to float32."""
    if precision == "f32":
        return x
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def linear(x, w, b, precision: str):
    """``x @ w.T + b`` with a (out, in) weight."""
    y = quantize(x, precision) @ quantize(w, precision).t()
    return y if b is None else y + b


def bmm(a, b, precision: str):
    """``a @ b`` over broadcast leading dims."""
    return quantize(a, precision) @ quantize(b, precision)


# ---- the configuration and the parameters ----------------------------------------------


def widths(m: dict) -> Tuple[int, ...]:
    return tuple(m["dim"] * 2 ** i for i in range(len(m["encoder_depths"])))


def grids(m: dict):
    """(levels, rows, columns) of each encoder stage."""
    h, w = m["lat"] // m["patch"], m["lon"] // m["patch"]
    return [(m["latent_levels"] + 1, h >> i, w >> i) for i in range(len(m["encoder_depths"]))]


def param_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter."""
    d, p, nt = m["dim"], m["patch"], m["history"]
    inner, r = m["perceiver_heads"] * m["perceiver_head_dim"], m["mlp_ratio"]

    def lin(name, n_in, n_out, bias=True):
        return {name + ".weight": (n_out, n_in), **({name + ".bias": (n_out,)} if bias else {})}

    def ln(name, n):
        return {name + ".weight": (n,), name + ".bias": (n,)}

    def perceiver(pre, n, ratio):
        return {**lin(pre + "to_q", n, inner, False), **lin(pre + "to_kv", n, 2 * inner, False),
                **lin(pre + "to_out", inner, n, False), **ln(pre + "norm1", n),
                **lin(pre + "mlp.linear1", n, ratio * n), **lin(pre + "mlp.linear2", ratio * n, n),
                **ln(pre + "norm2", n)}

    out = {"encoder.latents": (m["latent_levels"], d),
           **lin("encoder.surf_embed", (m["surface_vars"] + m["static_vars"]) * nt * p * p, d),
           **ln("encoder.surf_norm", d),
           **lin("encoder.atmos_embed", m["upper_vars"] * nt * p * p, d),
           **lin("encoder.level_embed", d, d), **perceiver("encoder.perceiver.", d, r)}
    for name in ("pos", "area", "lead", "time"):
        out.update(lin(f"encoder.{name}_embed", d, d))
    out.update({**lin("backbone.time_mlp.0", d, d), **lin("backbone.time_mlp.2", d, d)})

    def stage(pre, depth, c):
        for i in range(depth):
            b = f"{pre}.{i}."
            out.update({**lin(b + "qkv", c, 3 * c), **lin(b + "proj", c, c),
                        **lin(b + "norm1.modulation", d, 2 * c),
                        **lin(b + "mlp.linear1", c, r * c), **lin(b + "mlp.linear2", r * c, c),
                        **lin(b + "norm2.modulation", d, 2 * c)})

    ws = widths(m)
    for s, (depth, c) in enumerate(zip(m["encoder_depths"], ws)):
        stage(f"backbone.encoder.{s}", depth, c)
    for s, c in enumerate(ws[:-1]):
        out.update({**ln(f"backbone.down.{s}.norm", 4 * c),
                    **lin(f"backbone.down.{s}.linear", 4 * c, 2 * c, False)})
    for s, (depth, c) in enumerate(zip(m["decoder_depths"], ws[::-1])):
        stage(f"backbone.decoder.{s}", depth, c)
    for s, c in enumerate(ws[:0:-1]):
        out.update({**lin(f"backbone.up.{s}.linear1", c, 2 * c, False),
                    **ln(f"backbone.up.{s}.norm", c // 2),
                    **lin(f"backbone.up.{s}.linear2", c // 2, c // 2, False)})
    e = 2 * d
    out.update({**lin("decoder.level_embed", e, e),
                **perceiver("decoder.perceiver.", e, m["decoder_mlp_ratio"]),
                **lin("decoder.atmos_head", e, m["upper_vars"] * p * p),
                **lin("decoder.surf_head", e, m["surface_vars"] * p * p)})
    return out


@dataclass
class Constants:
    """The normalization statistics, (1, 5, levels, 1, 1) and (1, 4, 1, 1),
    and the static fields (3, lat, lon) in normalized units."""

    upper_mean: torch.Tensor
    upper_std: torch.Tensor
    surface_mean: torch.Tensor
    surface_std: torch.Tensor
    static: torch.Tensor


# ---- encodings --------------------------------------------------------------------------


def encode(x: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """F(x): (..., n) f32."""
    lo, hi = BOUNDS[name]
    lam = torch.logspace(math.log10(lo), math.log10(hi), n // 2, dtype=torch.float64)
    w = (2 * math.pi / lam).to(torch.float32).to(x.device)
    phase = x.float()[..., None] * w
    return torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)


def patch_centres_and_areas(m: dict, device):
    """(rows, columns) f32: each patch centre's latitude + 90, longitude, and area in km^2."""
    p, h, w = m["patch"], m["lat"] // m["patch"], m["lon"] // m["patch"]
    dlat, dlon = 180.0 / m["lat"], 360.0 / m["lon"]
    lat = 90.0 - dlat * (torch.arange(h, dtype=torch.float64) * p + (p - 1) / 2)
    lon = dlon * (torch.arange(w, dtype=torch.float64) * p + (p - 1) / 2)
    top = torch.clamp(lat + p * dlat / 2, max=90.0)
    bottom = torch.clamp(lat - p * dlat / 2, min=-90.0)
    band = torch.sin(torch.deg2rad(top)) - torch.sin(torch.deg2rad(bottom))
    area = RADIUS_KM ** 2 * math.radians(p * dlon) * band
    lat_grid = (lat + 90.0)[:, None].repeat(1, w)
    lon_grid = lon[None, :].repeat(h, 1)
    return (lat_grid.float().to(device), lon_grid.float().to(device),
            area[:, None].repeat(1, w).float().to(device))


# ---- the blocks -------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, P: dict, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], 1e-5)


def mlp(x: torch.Tensor, P: dict, pre: str, precision: str) -> torch.Tensor:
    y = F.gelu(linear(x, P[pre + "linear1.weight"], P[pre + "linear1.bias"], precision))
    return linear(y, P[pre + "linear2.weight"], P[pre + "linear2.bias"], precision)


def adaln(y: torch.Tensor, c: torch.Tensor, P: dict, pre: str, precision: str) -> torch.Tensor:
    """``LN(y) (1 + scale) + shift`` of y (B, Z, H, W, C); c (B, D)."""
    mod = linear(F.silu(c), P[pre + "modulation.weight"], P[pre + "modulation.bias"], precision)
    shift, scale = mod[:, None, None, None].chunk(2, dim=-1)
    return F.layer_norm(y, y.shape[-1:], eps=1e-5) * (1 + scale) + shift


def partition(x: torch.Tensor, window) -> torch.Tensor:
    """(B, Z, H, W, C) -> (B * nZ * nH * nW, T, C), windows level-major."""
    b, z, h, w, c = x.shape
    wz, wh, ww = window
    x = x.view(b, z // wz, wz, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wz * wh * ww, c)


def unpartition(x: torch.Tensor, window, b: int, z: int, h: int, w: int) -> torch.Tensor:
    wz, wh, ww = window
    x = x.view(b, z // wz, h // wh, w // ww, wz, wh, ww, -1).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, z, h, w, -1)


def region_mask(z: int, h: int, w: int, window, shift, device) -> torch.Tensor:
    """(nZ * nH * nW, T, T): -100 between tokens of different regions of the
    rolled grid, 0 within one; longitude wraps and is one region."""
    img = torch.zeros((1, z, h, w, 1), device=device)
    cnt = 0
    for zs in (slice(0, -window[0]), slice(-window[0], -shift[0]), slice(-shift[0], None)):
        for hs in (slice(0, -window[1]), slice(-window[1], -shift[1]), slice(-shift[1], None)):
            img[:, zs, hs] = cnt
            cnt += 1
    win = partition(img, window).squeeze(-1)
    return torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0)


def pads(n: int, k: int) -> Tuple[int, int]:
    extra = -n % k
    return extra // 2, extra - extra // 2


def block(x: torch.Tensor, c: torch.Tensor, P: dict, pre: str, heads: int, window,
          shifted: bool, precision: str) -> torch.Tensor:
    """One AdaLN 3D Swin block on (B, Z, H, W, C)."""
    b, z, h, w, ch = x.shape
    (pt, pb), (pl, pr) = pads(h, window[1]), pads(w, window[2])
    hp, wp = h + pt + pb, w + pl + pr
    bias = P[pre + "qkv.bias"]
    qkv = linear(x, P[pre + "qkv.weight"], bias, precision)
    full = bias.expand(b, z, hp, wp, 3 * ch).clone()
    full[:, :, pt:pt + h, pl:pl + w] = qkv
    shift = tuple(k // 2 for k in window)
    if shifted:
        full = torch.roll(full, [-s for s in shift], dims=(1, 2, 3))
    win = partition(full, window)
    n, t = win.shape[:2]
    q, k, v = win.reshape(n, t, 3, heads, ch // heads).permute(2, 0, 3, 1, 4)
    attn = bmm(q, k.transpose(-2, -1), precision) * (ch // heads) ** -0.5
    if shifted:
        mask = region_mask(z, hp, wp, window, shift, x.device)
        attn = (attn.view(b, -1, heads, t, t) + mask[None, :, None]).view(n, heads, t, t)
    o = bmm(torch.softmax(attn, dim=-1), v, precision).transpose(1, 2).reshape(n, t, ch)
    o = unpartition(o, window, b, z, hp, wp)
    if shifted:
        o = torch.roll(o, list(shift), dims=(1, 2, 3))
    o = o[:, :, pt:pt + h, pl:pl + w]
    x = x + adaln(linear(o, P[pre + "proj.weight"], P[pre + "proj.bias"], precision), c, P,
                  pre + "norm1.", precision)
    return x + adaln(mlp(x, P, pre + "mlp.", precision), c, P, pre + "norm2.", precision)


def merge(x: torch.Tensor, P: dict, pre: str, precision: str) -> torch.Tensor:
    """Swin patch merging: (B, Z, H, W, C) -> (B, Z, H/2, W/2, 2C)."""
    b, z, h, w, c = x.shape
    x = x.view(b, z, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    x = layer_norm(x.reshape(b, z, h // 2, w // 2, 4 * c), P, pre + "norm")
    return linear(x, P[pre + "linear.weight"], None, precision)


def split(x: torch.Tensor, P: dict, pre: str, precision: str) -> torch.Tensor:
    """Patch splitting: (B, Z, H, W, C) -> (B, Z, 2H, 2W, C/2)."""
    b, z, h, w, c = x.shape
    x = linear(x, P[pre + "linear1.weight"], None, precision)
    x = x.view(b, z, h, w, 2, 2, c // 2).permute(0, 1, 2, 4, 3, 5, 6)
    x = layer_norm(x.reshape(b, z, 2 * h, 2 * w, c // 2), P, pre + "norm")
    return linear(x, P[pre + "linear2.weight"], None, precision)


def perceiver(P: dict, pre: str, latents: torch.Tensor, ctx: torch.Tensor, m: dict,
              ratio: int, precision: str) -> torch.Tensor:
    """One Perceiver layer: latents (n, E), the same at every patch, attend
    to ctx (N, k, E) -> (N, n, E)."""
    heads, hd = m["perceiver_heads"], m["perceiver_head_dim"]
    n, (bn, k) = latents.shape[0], ctx.shape[:2]
    q = linear(latents, P[pre + "to_q.weight"], None, precision).view(n, heads, hd).transpose(0, 1)
    kv = linear(ctx, P[pre + "to_kv.weight"], None, precision)
    key, val = (t.reshape(bn, k, heads, hd).transpose(1, 2) for t in kv.chunk(2, dim=-1))
    attn = torch.softmax(bmm(q, key.transpose(-2, -1), precision) * hd ** -0.5, dim=-1)
    o = bmm(attn, val, precision).transpose(1, 2).reshape(bn, n, heads * hd)
    x = latents + layer_norm(linear(o, P[pre + "to_out.weight"], None, precision), P,
                             pre + "norm1")
    return x + layer_norm(mlp(x, P, pre + "mlp.", precision), P, pre + "norm2")


# ---- the step ---------------------------------------------------------------------------


def _forward(P: dict, m: dict, up_prev, sf_prev, up, sf, hours, k: Constants, precision: str):
    b, p, nt = up.shape[0], m["patch"], m["history"]
    h, w, d = m["lat"] // p, m["lon"] // p, m["dim"]
    lv, vu, vs, nl = len(m["pressures"]), m["upper_vars"], m["surface_vars"], m["latent_levels"]
    pressures = torch.tensor(m["pressures"], dtype=torch.float32, device=up.device)

    def emb(x, name):
        return linear(x, P[name + ".weight"], P[name + ".bias"], precision)

    # the encoder
    a = torch.stack([(x - k.upper_mean) / k.upper_std for x in (up_prev, up)], dim=2)
    a = a.reshape(b, vu, nt, lv, h, p, w, p).permute(0, 3, 4, 6, 1, 2, 5, 7)
    atmos = emb(a.reshape(b, lv, h, w, -1), "encoder.atmos_embed")
    atmos = atmos + emb(encode(pressures, d, "pressure"), "encoder.level_embed")[:, None, None]
    s = torch.stack([(x - k.surface_mean) / k.surface_std for x in (sf_prev, sf)], dim=2)
    s = torch.cat([s, k.static[None, :, None].expand(b, -1, nt, -1, -1)], dim=1)
    s = s.reshape(b, -1, nt, h, p, w, p).permute(0, 3, 5, 1, 2, 4, 6).reshape(b, h, w, -1)
    surf = layer_norm(emb(s, "encoder.surf_embed"), P, "encoder.surf_norm")
    ctx = atmos.permute(0, 2, 3, 1, 4).reshape(b * h * w, lv, d)
    lat = perceiver(P, "encoder.perceiver.", P["encoder.latents"], ctx, m, m["mlp_ratio"],
                    precision)
    x = torch.cat([surf[:, None], lat.view(b, h, w, nl, d).permute(0, 3, 1, 2, 4)], dim=1)
    rows, cols, area = patch_centres_and_areas(m, up.device)
    pos = torch.cat([encode(rows, d // 2, "position"), encode(cols, d // 2, "position")], -1)
    lead = encode(torch.full((b,), float(m["lead_hours"]), device=up.device), d, "lead")
    x = (x + emb(pos, "encoder.pos_embed") + emb(encode(area, d, "area"), "encoder.area_embed")
         + emb(lead, "encoder.lead_embed")[:, None, None, None]
         + emb(encode(hours, d, "time"), "encoder.time_embed")[:, None, None, None])

    # the backbone
    c = emb(F.silu(emb(lead, "backbone.time_mlp.0")), "backbone.time_mlp.2")
    window = tuple(m["window"])

    def stage(x, pre, depth, heads):
        for i in range(depth):
            x = block(x, c, P, f"{pre}.{i}.", heads, window, bool(i % 2), precision)
        return x

    n = len(m["encoder_depths"])
    skips = []
    for s, (depth, heads) in enumerate(zip(m["encoder_depths"], m["encoder_heads"])):
        x = stage(x, f"backbone.encoder.{s}", depth, heads)
        if s < n - 1:
            skips.append(x)
            x = merge(x, P, f"backbone.down.{s}.", precision)
    for s, (depth, heads) in enumerate(zip(m["decoder_depths"], m["decoder_heads"])):
        x = stage(x, f"backbone.decoder.{s}", depth, heads)
        if s < n - 1:
            x = split(x, P, f"backbone.up.{s}.", precision) + skips[n - 2 - s]
    x = torch.cat([x, skips[0]], dim=-1)

    # the decoder
    e = 2 * d
    queries = emb(encode(pressures, e, "pressure"), "decoder.level_embed")
    ctx = x[:, 1:].permute(0, 2, 3, 1, 4).reshape(b * h * w, nl, e)
    out = perceiver(P, "decoder.perceiver.", queries, ctx, m, m["decoder_mlp_ratio"], precision)
    atmos = emb(out, "decoder.atmos_head").reshape(b, h, w, lv, vu, p, p)
    upper = atmos.permute(0, 4, 3, 1, 5, 2, 6).reshape(b, vu, lv, h * p, w * p)
    surface = emb(x[:, 0], "decoder.surf_head").reshape(b, h, w, vs, p, p)
    surface = surface.permute(0, 3, 1, 4, 2, 5).reshape(b, vs, h * p, w * p)
    return upper, surface


def forward(P: dict, m: dict, upper_prev, surface_prev, upper, surface, hours,
            k: Constants, precision: str = "f32"):
    """Physical states at t - 6 h and t and the clock at t (hours since 1970,
    (B,) f32) -> the normalized (upper, surface) at t + 6 h, with TF32 off
    for the call."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(P, m, upper_prev, surface_prev, upper, surface, hours, k, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def to_physical(upper: torch.Tensor, surface: torch.Tensor, k: Constants):
    return upper * k.upper_std + k.upper_mean, surface * k.surface_std + k.surface_mean
