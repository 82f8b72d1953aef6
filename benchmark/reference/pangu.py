"""Pangu-Weather (Bi et al., arXiv:2211.02556, Methods and the official
pseudocode) in plain PyTorch, as a function of a state dict.

Parameter names and shapes are those of the published PyTorch state dict
(``param_shapes``). The layout conventions are the published ones: the
surface plane is token level 0, latitude is padded at its end, window types
enumerate (z window, lat window) pairs z-major, a window's tokens are
(z, lat, lon)-major, the shifted blocks roll by half a window on all three
axes and mask the regions the roll joins (the pseudocode's labelling, with
its middle latitude slice ``[wh, Hp - wh/2)``; longitude wraps, as the
sphere does), and every block re-zeroes the latitude pad rows at its entry.

Every product runs through ``linear`` and ``bmm``, which compute in
``precision``: "f32" (float32, TF32 off), or a control that rounds each
product's operands to a lower precision first ("tf32": a 10-bit mantissa;
"fp8": float8 e4m3 with one scale per tensor), in the forward and in the
backward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("f32", "tf32", "fp8")
_FP8_MAX = 448.0


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


class _QLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, precision):
        ctx.save_for_backward(x, w)
        ctx.precision = precision
        return quantize(x, precision) @ quantize(w, precision).t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        p = ctx.precision
        qg = quantize(g, p)
        gx = qg @ quantize(w, p)
        gw = qg.reshape(-1, qg.shape[-1]).t() @ quantize(x, p).reshape(-1, x.shape[-1])
        return gx, gw, None


class _QBmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return quantize(a, precision) @ quantize(b, precision)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.precision
        qg = quantize(g, p)
        return qg @ quantize(b, p).transpose(-1, -2), quantize(a, p).transpose(-1, -2) @ qg, None


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           precision: str) -> torch.Tensor:
    """``x @ w.T + b`` with a (out, in) weight."""
    y = x @ w.t() if precision == "f32" else _QLinear.apply(x, w, precision)
    return y if b is None else y + b


def bmm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` over equal leading dims."""
    return a @ b if precision == "f32" else _QBmm.apply(a, b, precision)


# ---- geometry ------------------------------------------------------------------------


@dataclass(frozen=True)
class Stage:
    z: int
    h: int
    w: int
    hp: int  # h padded to whole lat windows
    window: Tuple[int, int, int]

    @property
    def n_types(self) -> int:
        return (self.z // self.window[0]) * (self.hp // self.window[1])

    @property
    def tokens(self) -> int:
        return self.window[0] * self.window[1] * self.window[2]


@dataclass(frozen=True)
class Grid:
    lat_pad: int
    level_pad: int
    zu: int  # patch levels of the upper air
    h: int
    w: int
    h_down_pad: int
    h2: int
    outer: Stage
    inner: Stage


def _pad(n: int, m: int) -> int:
    return (-n) % m


def grid(m: dict) -> Grid:
    pz, ph, pw = m["patch"]
    win = tuple(m["window"])
    zu = (m["levels"] + _pad(m["levels"], pz)) // pz
    h, w = (m["lat"] + _pad(m["lat"], ph)) // ph, m["lon"] // pw
    h2 = (h + _pad(h, 2)) // 2

    def stage(sh: int, sw: int) -> Stage:
        return Stage(zu + 1, sh, sw, sh + _pad(sh, win[1]), win)

    return Grid(_pad(m["lat"], ph), _pad(m["levels"], pz), zu, h, w, _pad(h, 2), h2,
                stage(h, w), stage(h2, w // 2))


def stage_of(m: dict, layer: int) -> Stage:
    g = grid(m)
    return (g.outer, g.inner, g.inner, g.outer)[layer]


# ---- parameters ----------------------------------------------------------------------


def param_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter, in the published state dict's order."""
    pz, ph, pw = m["patch"]
    c0, c3 = m["dims"][0], m["dims"][3]
    vu, vs = m["upper_vars"], m["surface_vars"]
    out = {
        "_input_layer.conv.weight": (c0, (vu + m["upper_const_channels"]) * pz * ph * pw, 1),
        "_input_layer.conv.bias": (c0,),
        "_input_layer.conv_surface.weight": (c0, (vs + m["surface_const_channels"]) * ph * pw, 1),
        "_input_layer.conv_surface.bias": (c0,),
    }
    for i, (depth, c, heads) in enumerate(zip(m["depths"], m["dims"], m["heads"])):
        st, r = stage_of(m, i), m["mlp_ratio"]
        for j in range(depth):
            p = f"layers.EarthSpecificLayer{i}.blocks.EarthSpecificBlock{j}."
            out.update({
                p + "norm1.weight": (c,), p + "norm1.bias": (c,),
                p + "norm2.weight": (c,), p + "norm2.bias": (c,),
                p + "linear.linear1.weight": (r * c, c), p + "linear.linear1.bias": (r * c,),
                p + "linear.linear2.weight": (c, r * c), p + "linear.linear2.bias": (c,),
                p + "attention.earth_specific_bias": (1, st.n_types, heads, st.tokens, st.tokens),
                p + "attention.linear1.weight": (3 * c, c), p + "attention.linear1.bias": (3 * c,),
                p + "attention.linear2.weight": (c, c), p + "attention.linear2.bias": (c,),
            })
        if i == 0:
            out.update({"downsample.norm.weight": (4 * c,), "downsample.norm.bias": (4 * c,),
                        "downsample.linear.weight": (2 * c, 4 * c)})
        if i == 2:
            o = m["dims"][3]
            out.update({"upsample.linear1.weight": (4 * o, c), "upsample.norm.weight": (o,),
                        "upsample.norm.bias": (o,), "upsample.linear2.weight": (o, o)})
    cin = c0 + c3
    out.update({
        "_output_layer.conv.weight": (vu * pz * ph * pw, cin, 1),
        "_output_layer.conv.bias": (vu * pz * ph * pw,),
        "_output_layer.conv_surface.weight": (vs * ph * pw, cin, 1),
        "_output_layer.conv_surface.bias": (vs * ph * pw,),
    })
    return out


# ---- the constants -------------------------------------------------------------------


@dataclass
class Constants:
    """Normalization statistics, constant fields and loss weights."""

    surface_mean: torch.Tensor  # (1, Vs, 1, 1)
    surface_std: torch.Tensor
    upper_mean: torch.Tensor  # (1, Vu, L, 1, 1)
    upper_std: torch.Tensor
    surface_mask: torch.Tensor  # (3, lat + lat_pad, lon)
    const_h: torch.Tensor  # (1, L, lat, lon)
    upper_weights: torch.Tensor  # (1, Vu, 1, 1, 1)
    surface_weights: torch.Tensor  # (1, Vs, 1, 1)
    upper_loss_weight: float
    surface_loss_weight: float


# ---- the model -----------------------------------------------------------------------


def shift_mask(st: Stage, device) -> torch.Tensor:
    """(n_types, T, T) additive mask of the shifted windows: -100 between
    tokens of different regions, 0 within one."""
    wz, wh, ww = st.window
    label = torch.zeros(st.z, st.hp, dtype=torch.int64)
    n = 0
    for zs in (slice(0, st.z - wz), slice(st.z - wz, st.z - wz // 2), slice(st.z - wz // 2, st.z)):
        for hs in (slice(0, st.hp - wh), slice(wh, st.hp - wh // 2),
                   slice(st.hp - wh // 2, st.hp)):
            label[zs, hs] = n
            n += 1
    lab = label.reshape(st.z // wz, wz, st.hp // wh, wh).permute(0, 2, 1, 3)
    lab = lab.reshape(st.n_types, wz, wh, 1).expand(st.n_types, wz, wh, ww)
    lab = lab.reshape(st.n_types, st.tokens)
    differ = lab[:, :, None] != lab[:, None, :]
    return torch.where(differ, -100.0, 0.0).to(device)


def to_windows(x: torch.Tensor, win) -> torch.Tensor:
    """(B, Z, Hp, W, C) -> (B, lon windows, types, T, C)."""
    wz, wh, ww = win
    b, z, h, w, c = x.shape
    x = x.reshape(b, z // wz, wz, h // wh, wh, w // ww, ww, c).permute(0, 5, 1, 3, 2, 4, 6, 7)
    return x.reshape(b, w // ww, (z // wz) * (h // wh), wz * wh * ww, c)


def from_windows(x: torch.Tensor, win, z: int, h: int, w: int) -> torch.Tensor:
    wz, wh, ww = win
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, w // ww, z // wz, h // wh, wz, wh, ww, c).permute(0, 2, 4, 3, 5, 1, 6, 7)
    return x.reshape(b, z, h, w, c)


def layer_norm(x: torch.Tensor, P: dict, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], 1e-5)


def attention(x: torch.Tensor, P: dict, pre: str, st: Stage, heads: int,
              mask: Optional[torch.Tensor], precision: str) -> torch.Tensor:
    b, z, hp, w, c = x.shape
    d = c // heads
    xw = to_windows(x, st.window)
    nw, nt, t = xw.shape[1:4]
    qkv = linear(xw, P[pre + "linear1.weight"], P[pre + "linear1.bias"], precision)
    q, k, v = qkv.reshape(b, nw, nt, t, 3, heads, d).permute(4, 0, 1, 2, 5, 3, 6)
    s = bmm(q * d ** -0.5, k.transpose(-1, -2), precision)
    s = s + P[pre + "earth_specific_bias"][0]
    if mask is not None:
        s = s + mask[:, None]
    o = bmm(torch.softmax(s, dim=-1), v, precision)
    o = o.permute(0, 1, 2, 4, 3, 5).reshape(b, nw, nt, t, c)
    o = linear(o, P[pre + "linear2.weight"], P[pre + "linear2.bias"], precision)
    return from_windows(o, st.window, z, hp, w)


def block(x: torch.Tensor, P: dict, pre: str, st: Stage, heads: int, shifted: bool,
          s1: Optional[torch.Tensor], s2: Optional[torch.Tensor], precision: str) -> torch.Tensor:
    """One block on the padded grid; ``s1``/``s2`` the drop-path scales (None: 1)."""
    x = F.pad(x[:, :, :st.h], (0, 0, 0, 0, 0, st.hp - st.h))
    shortcut = x
    shift = tuple(n // 2 for n in st.window)
    if shifted:
        x = torch.roll(x, tuple(-s for s in shift), dims=(1, 2, 3))
    mask = shift_mask(st, x.device) if shifted else None
    y = attention(x, P, pre + "attention.", st, heads, mask, precision)
    if shifted:
        y = torch.roll(y, shift, dims=(1, 2, 3))
    y = layer_norm(y, P, pre + "norm1")
    x = shortcut + (y if s1 is None else s1 * y)
    h = F.gelu(linear(x, P[pre + "linear.linear1.weight"], P[pre + "linear.linear1.bias"],
                      precision))
    h = linear(h, P[pre + "linear.linear2.weight"], P[pre + "linear.linear2.bias"], precision)
    h = layer_norm(h, P, pre + "norm2")
    return x + (h if s2 is None else s2 * h)


def drop_path_rates(m: dict) -> List[List[float]]:
    """The stochastic-depth rate of every block: a linear ramp from 0 to
    ``drop_path_max`` over all blocks in order, in float64."""
    n = sum(m["depths"])
    step = m["drop_path_max"] / (n - 1) if n > 1 else 0.0
    ramp = [i * step for i in range(n)]
    ramp[-1] = m["drop_path_max"] if n > 1 else 0.0
    out, off = [], 0
    for depth in m["depths"]:
        out.append(ramp[off:off + depth])
        off += depth
    return out


def drop_path_scales(m: dict, batch: int, generator: torch.Generator,
                     device) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Each block's two per-sample branch scales (B, 1, 1, 1, 1), drawn from
    ``generator`` in block order: for a block of rate r > 0, two draws of B
    uniforms, a sample kept (scale 1 / (1 - r)) where its uniform is below
    1 - r, else dropped (0); a block of rate 0 draws nothing."""
    out = []
    for rates in drop_path_rates(m):
        layer = []
        for rate in rates:
            pair = []
            for _ in range(2):
                if rate <= 0.0:
                    pair.append(torch.ones((batch, 1, 1, 1, 1), device=device))
                    continue
                keep = 1.0 - rate
                u = torch.rand((batch,), generator=generator, device=generator.device).to(device)
                pair.append(torch.where(u < keep, 1.0 / keep, 0.0).reshape(batch, 1, 1, 1, 1))
            layer.append(tuple(pair))
        out.append(layer)
    return out


def embed(P: dict, m: dict, upper: torch.Tensor, surface: torch.Tensor, k: Constants,
          precision: str) -> torch.Tensor:
    g = grid(m)
    pz, ph, pw = m["patch"]
    b = surface.shape[0]
    s = (surface - k.surface_mean) / k.surface_std
    s = F.pad(s, (0, 0, 0, g.lat_pad))
    s = torch.cat([s, k.surface_mask[None].expand(b, *k.surface_mask.shape)], dim=1)
    cs = s.shape[1]
    s = s.reshape(b, cs, g.h, ph, g.w, pw).permute(0, 2, 4, 1, 3, 5).reshape(b, g.h, g.w, -1)
    s = linear(s, P["_input_layer.conv_surface.weight"][:, :, 0],
               P["_input_layer.conv_surface.bias"], precision)
    u = (upper - k.upper_mean) / k.upper_std
    u = torch.cat([u, k.const_h[None].expand(b, *k.const_h.shape)], dim=1)
    u = F.pad(u, (0, 0, 0, g.lat_pad, 0, g.level_pad))
    cu = u.shape[1]
    u = u.reshape(b, cu, g.zu, pz, g.h, ph, g.w, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    u = linear(u.reshape(b, g.zu, g.h, g.w, -1), P["_input_layer.conv.weight"][:, :, 0],
               P["_input_layer.conv.bias"], precision)
    return torch.cat([s[:, None], u], dim=1)


def recover(P: dict, m: dict, x: torch.Tensor, precision: str):
    g = grid(m)
    pz, ph, pw = m["patch"]
    b, vu, vs = x.shape[0], m["upper_vars"], m["surface_vars"]
    up = linear(x[:, 1:], P["_output_layer.conv.weight"][:, :, 0], P["_output_layer.conv.bias"],
                precision)
    up = up.reshape(b, g.zu, g.h, g.w, vu, pz, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
    up = up.reshape(b, vu, g.zu * pz, g.h * ph, g.w * pw)[:, :, :m["levels"], :m["lat"]]
    sf = linear(x[:, 0], P["_output_layer.conv_surface.weight"][:, :, 0],
                P["_output_layer.conv_surface.bias"], precision)
    sf = sf.reshape(b, g.h, g.w, vs, ph, pw).permute(0, 3, 1, 4, 2, 5)
    return up, sf.reshape(b, vs, g.h * ph, g.w * pw)[:, :, :m["lat"]]


def _layer(x, P, m, i, scales, precision, remat):
    st = stage_of(m, i)
    x = F.pad(x, (0, 0, 0, 0, 0, st.hp - st.h))
    for j in range(m["depths"][i]):
        s1, s2 = scales[i][j] if scales is not None else (None, None)
        args = (P, f"layers.EarthSpecificLayer{i}.blocks.EarthSpecificBlock{j}.", st,
                m["heads"][i], bool(j % 2), s1, s2, precision)
        if remat:
            x = checkpoint(lambda x_, a=args: block(x_, *a), x, use_reentrant=False)
        else:
            x = block(x, *args)
    return x[:, :, :st.h]


def forward(P: dict, m: dict, upper: torch.Tensor, surface: torch.Tensor, k: Constants,
            precision: str = "f32", scales=None, remat: bool = False):
    """Physical fields at t -> normalized fields at t + 24 h (upper, surface).
    ``scales`` are the drop-path scales of a training step (None: eval);
    ``remat`` checkpoints each block."""
    g = grid(m)
    x = embed(P, m, upper, surface, k, precision)
    x = _layer(x, P, m, 0, scales, precision, remat)
    skip = x
    b, z, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, 0, 0, g.h_down_pad)).reshape(b, z, g.h2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, z, g.h2, w // 2, 4 * c)
    x = linear(layer_norm(x, P, "downsample.norm"), P["downsample.linear.weight"], None, precision)
    x = _layer(x, P, m, 1, scales, precision, remat)
    x = _layer(x, P, m, 2, scales, precision, remat)
    o = m["dims"][3]
    x = linear(x, P["upsample.linear1.weight"], None, precision)
    x = x.reshape(b, z, g.h2, w // 2, 2, 2, o).permute(0, 1, 2, 4, 3, 5, 6)
    x = x.reshape(b, z, 2 * g.h2, w, o)[:, :, :g.h]
    x = linear(layer_norm(x, P, "upsample.norm"), P["upsample.linear2.weight"], None, precision)
    x = _layer(x, P, m, 3, scales, precision, remat)
    return recover(P, m, torch.cat([skip, x], dim=-1), precision)


def to_physical(up: torch.Tensor, sf: torch.Tensor, k: Constants):
    return up * k.upper_std + k.upper_mean, sf * k.surface_std + k.surface_mean


def loss(out_u, out_s, target_u, target_s, k: Constants) -> torch.Tensor:
    """The weighted L1 loss of normalized outputs against physical targets:
    per-variable weights, mean over every point, upper + surface weighted."""
    tu = (target_u - k.upper_mean) / k.upper_std
    ts = (target_s - k.surface_mean) / k.surface_std
    lu = ((out_u - tu).abs() * k.upper_weights).mean()
    ls = ((out_s - ts).abs() * k.surface_weights).mean()
    return lu * k.upper_loss_weight + ls * k.surface_loss_weight


class Adam:
    """Adam with L2 weight decay added to the gradient before the moments,
    bias-corrected moments and eps added after the square root."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, weight_decay, betas, eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update in place; returns the gradients as the update took them
        (decay added)."""
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        taken = {}
        for n, p in self.params.items():
            g = grads[n] + self.wd * p
            taken[n] = g
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[n].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)
        return taken
