"""FuXi (Chen et al. 2023, arXiv:2306.12873, the model section) in plain
PyTorch, as a function of a state dict, with Swin Transformer V2's block
(Liu et al. 2022, arXiv:2111.09883, and its official code's
``WindowAttention`` and ``SwinTransformerBlock``).

The step: two physical states (t - 6 h, t), each (B, V, lat, lon),
normalized and stacked on a time axis; a Conv3d with kernel and stride
(2, 4, 4) to C channels and a LayerNorm; the Down Block (Conv2d 3x3 stride
2, a residual block); ``depth`` Swin V2 blocks, every other one shifted;
the Up Block (the concat of the Down Block's output and the blocks', a
ConvTranspose2d 2C -> C 2x2 stride 2, a residual block); a Linear head to
V x 4 x 4 a token, pixel-shuffled and bilinearly interpolated to the
grid. It returns the next state normalized.

Values the paper leaves open, assumed here as in the configuration file's
``assumed``:

- the window 9x9, shifted by 4 (it tiles the 90x180 token grid); windows
  are square here (the configuration's ``window[0]``);
- heads of 32 channels (48 at C = 1536), Swin V2's width at every size;
- GroupNorm of 32 groups, eps 1e-5; LayerNorm eps 1e-5;
- the residual block ``h = SiLU(GN(conv3x3(x)))``,
  ``h = SiLU(GN(conv3x3(h)))``, ``x + h``, every convolution with a bias;
- the Up Block as above, the concat ordered (Down Block, blocks);
- the embedding drops the last latitude row, which a stride-4 convolution
  over 721 rows does not reach;
- the head's features ordered (variable, lat, lon), pixel-shuffled to
  (lat - 1) x lon, then ``interpolate(size=(lat, lon), mode="bilinear",
  align_corners=False)``; it gives the next normalized state directly;
- the shift masks Swin's nine regions (-100 between regions), and
  longitude does not wrap;
- no inputs beside the two states.

Departures: none from the equations; the program computes the same
mathematics in another order (its embedding as one product over patches,
its attention through ``scaled_dot_product_attention`` with the windows
gathered by index), which moves only the rounding.

Every product runs through ``linear``, ``bmm`` and the convolution helpers,
which compute in ``precision``: "f32" (float32, TF32 off, which ``forward``
sees to), or a control that rounds each product's operands to a lower
precision first ("tf32": a 10-bit mantissa; "fp8": float8 e4m3 with one
scale per tensor). The model is forecast-only: no backward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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


def linear(x, w, b, precision: str):
    """``x @ w.T + b`` with a (out, in) weight."""
    y = quantize(x, precision) @ quantize(w, precision).t()
    return y if b is None else y + b


def bmm(a, b, precision: str):
    """``a @ b`` over equal leading dims."""
    return quantize(a, precision) @ quantize(b, precision)


def conv2d(x, w, b, precision: str, **kw):
    return F.conv2d(quantize(x, precision), quantize(w, precision), b, **kw)


def conv3d(x, w, b, precision: str, **kw):
    return F.conv3d(quantize(x, precision), quantize(w, precision), b, **kw)


def conv_transpose2d(x, w, b, precision: str, **kw):
    return F.conv_transpose2d(quantize(x, precision), quantize(w, precision), b, **kw)


# ---- the configuration and the parameters ----------------------------------------------


def grid(m: dict) -> Tuple[int, int]:
    """(rows, columns) of the cube embedding."""
    _, kh, kw = m["cube"]
    return (m["lat"] - kh) // kh + 1, m["lon"] // kw


def param_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter."""
    c, v, heads, hid, r = m["dim"], m["variables"], m["heads"], m["cpb_hidden"], m["mlp_ratio"]
    kt, kh, kw = m["cube"]

    def res(p):
        return {p + "conv1.weight": (c, c, 3, 3), p + "conv1.bias": (c,),
                p + "norm1.weight": (c,), p + "norm1.bias": (c,),
                p + "conv2.weight": (c, c, 3, 3), p + "conv2.bias": (c,),
                p + "norm2.weight": (c,), p + "norm2.bias": (c,)}

    out = {"embed.proj.weight": (c, v, kt, kh, kw), "embed.proj.bias": (c,),
           "embed.norm.weight": (c,), "embed.norm.bias": (c,),
           "down.conv.weight": (c, c, 3, 3), "down.conv.bias": (c,)}
    out.update(res("down.res."))
    for i in range(m["depth"]):
        p = f"blocks.{i}."
        out.update({
            p + "attn.qkv.weight": (3 * c, c), p + "attn.q_bias": (c,), p + "attn.v_bias": (c,),
            p + "attn.logit_scale": (heads, 1, 1),
            p + "attn.cpb_mlp.0.weight": (hid, 2), p + "attn.cpb_mlp.0.bias": (hid,),
            p + "attn.cpb_mlp.2.weight": (heads, hid),
            p + "attn.proj.weight": (c, c), p + "attn.proj.bias": (c,),
            p + "norm1.weight": (c,), p + "norm1.bias": (c,),
            p + "mlp.linear1.weight": (r * c, c), p + "mlp.linear1.bias": (r * c,),
            p + "mlp.linear2.weight": (c, r * c), p + "mlp.linear2.bias": (c,),
            p + "norm2.weight": (c,), p + "norm2.bias": (c,),
        })
    out.update({"up.conv.weight": (2 * c, c, 2, 2), "up.conv.bias": (c,)})
    out.update(res("up.res."))
    out.update({"head.weight": (v * kh * kw, c), "head.bias": (v * kh * kw,)})
    return out


@dataclass
class Constants:
    """The normalization statistics of the variables, (1, V, 1, 1)."""

    mean: torch.Tensor
    std: torch.Tensor


# ---- Swin V2's block -------------------------------------------------------------------


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws * ws, C), windows lat-major."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // (h // ws * (w // ws))
    x = x.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def coords_table(ws: int) -> torch.Tensor:
    """(2 ws - 1, 2 ws - 1, 2): the relative offsets, divided by ws - 1,
    times 8, then ``sign(t) log2(|t| + 1) / log2(8)``."""
    r = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij")).permute(1, 2, 0)
    t = t / (ws - 1) * 8
    return torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8)


def position_index(ws: int) -> torch.Tensor:
    """(ws^2, ws^2): each (query, key)'s row of the flattened table."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    return (rel[..., 0] + ws - 1) * (2 * ws - 1) + rel[..., 1] + ws - 1


def position_bias(P: dict, pre: str, ws: int, heads: int, precision: str) -> torch.Tensor:
    """(heads, T, T): ``16 sigmoid(cpb_mlp(table))`` at each (query, key)."""
    dev = P[pre + "cpb_mlp.0.weight"].device
    h = torch.relu(linear(coords_table(ws).to(dev), P[pre + "cpb_mlp.0.weight"],
                          P[pre + "cpb_mlp.0.bias"], precision))
    table = linear(h, P[pre + "cpb_mlp.2.weight"], None, precision).view(-1, heads)
    t = ws * ws
    bias = table[position_index(ws).to(dev).view(-1)].view(t, t, heads).permute(2, 0, 1)
    return 16 * torch.sigmoid(bias)


def attn_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    """(nW, T, T): -100 between tokens of different regions of the rolled
    grid, 0 within one."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = window_partition(img, ws).squeeze(-1)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def attention(x: torch.Tensor, P: dict, pre: str, heads: int, ws: int,
              mask, precision: str) -> torch.Tensor:
    """Scaled cosine attention of windows (N, T, C)."""
    n, t, c = x.shape
    qkv_bias = torch.cat([P[pre + "q_bias"], torch.zeros_like(P[pre + "q_bias"]),
                          P[pre + "v_bias"]])
    qkv = linear(x, P[pre + "qkv.weight"], qkv_bias, precision)
    q, k, v = qkv.reshape(n, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    attn = bmm(F.normalize(q, dim=-1), F.normalize(k, dim=-1).transpose(-2, -1), precision)
    scale = torch.clamp(P[pre + "logit_scale"], max=math.log(1.0 / 0.01)).exp()
    attn = attn * scale + position_bias(P, pre, ws, heads, precision)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(n // nw, nw, heads, t, t) + mask[None, :, None]
        attn = attn.view(n, heads, t, t)
    out = bmm(torch.softmax(attn, dim=-1), v, precision)
    out = out.transpose(1, 2).reshape(n, t, c)
    return linear(out, P[pre + "proj.weight"], P[pre + "proj.bias"], precision)


def layer_norm(x: torch.Tensor, P: dict, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], 1e-5)


def block(x: torch.Tensor, P: dict, pre: str, m: dict, shifted: bool,
          precision: str) -> torch.Tensor:
    """One Swin V2 block on (B, H, W, C): res-post-norm."""
    b, h, w, c = x.shape
    ws = m["window"][0]
    shift = ws // 2 if shifted else 0
    y = torch.roll(x, (-shift, -shift), dims=(1, 2)) if shifted else x
    mask = attn_mask(h, w, ws, shift, x.device) if shifted else None
    y = attention(window_partition(y, ws), P, pre + "attn.", m["heads"], ws, mask, precision)
    y = window_reverse(y, ws, h, w)
    if shifted:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    x = x + layer_norm(y, P, pre + "norm1")
    y = F.gelu(linear(x, P[pre + "mlp.linear1.weight"], P[pre + "mlp.linear1.bias"], precision))
    y = linear(y, P[pre + "mlp.linear2.weight"], P[pre + "mlp.linear2.bias"], precision)
    return x + layer_norm(y, P, pre + "norm2")


# ---- the convolutional parts -----------------------------------------------------------


def residual(x: torch.Tensor, P: dict, pre: str, m: dict, precision: str) -> torch.Tensor:
    """(B, C, H, W) -> x + SiLU(GN(conv(SiLU(GN(conv(x))))))."""
    h = x
    for i in (1, 2):
        h = conv2d(h, P[f"{pre}conv{i}.weight"], P[f"{pre}conv{i}.bias"], precision, padding=1)
        h = F.silu(F.group_norm(h, m["groups"], P[f"{pre}norm{i}.weight"],
                                P[f"{pre}norm{i}.bias"], 1e-5))
    return x + h


def _forward(P: dict, m: dict, x_prev: torch.Tensor, x_cur: torch.Tensor, k: Constants,
             precision: str) -> torch.Tensor:
    b, v = x_cur.shape[:2]
    _, kh, kw = m["cube"]
    x = torch.stack([(x_prev - k.mean) / k.std, (x_cur - k.mean) / k.std], dim=2)
    x = conv3d(x, P["embed.proj.weight"], P["embed.proj.bias"], precision,
               stride=tuple(m["cube"]))[:, :, 0]
    x = layer_norm(x.permute(0, 2, 3, 1), P, "embed.norm").permute(0, 3, 1, 2)
    x = conv2d(x, P["down.conv.weight"], P["down.conv.bias"], precision, stride=2, padding=1)
    x = residual(x, P, "down.res.", m, precision)
    skip = x
    x = x.permute(0, 2, 3, 1)
    for i in range(m["depth"]):
        x = block(x, P, f"blocks.{i}.", m, bool(i % 2), precision)
    x = torch.cat([skip, x.permute(0, 3, 1, 2)], dim=1)
    x = conv_transpose2d(x, P["up.conv.weight"], P["up.conv.bias"], precision, stride=2)
    x = residual(x, P, "up.res.", m, precision)
    y = linear(x.permute(0, 2, 3, 1), P["head.weight"], P["head.bias"], precision)
    h, w = y.shape[1:3]
    y = y.reshape(b, h, w, v, kh, kw).permute(0, 3, 1, 4, 2, 5).reshape(b, v, h * kh, w * kw)
    return F.interpolate(y, size=(m["lat"], m["lon"]), mode="bilinear", align_corners=False)


def forward(P: dict, m: dict, x_prev: torch.Tensor, x_cur: torch.Tensor, k: Constants,
            precision: str = "f32") -> torch.Tensor:
    """Physical states at t - 6 h and t -> the normalized state at t + 6 h,
    with TF32 off for the call."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(P, m, x_prev, x_cur, k, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def to_physical(y: torch.Tensor, k: Constants) -> torch.Tensor:
    return y * k.std + k.mean
