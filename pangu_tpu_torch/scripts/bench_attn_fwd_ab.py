"""A/B of attention-forward schedules on one CUDA card (port of
``scripts/bench_attn_fwd_ab.py``).

    python -m pangu_tpu_torch.scripts.bench_attn_fwd_ab [variant ...]

Every variant computes ``y = attn(x) @ Wproj^T + bproj`` (mask-free) on the
outer-stage grid (1, 8, 186, 360, 192), 6 heads, window (2, 6, 12):

* ``shipped``: the port's K2, ``ops.fused_block_attention.fused_block_attention``;
* ``batched``: one CTA per window for all heads, the window's x staged once
  (``csrc/bench_attn_fwd_ab.cu`` at NW = 1);
* ``dbl`` / ``quad``: fat windows of NW = 2 / 4 lon windows, their tokens in
  the interleaved order of the contiguous (wz, wh, NW ww) slice, scored all
  against all with the bias table of :func:`interleave_bias` (-1e9 on
  cross-window pairs, so their probabilities are exactly 0), the same kernel
  at NW = 2, 4. ``quad`` needs the lon windows to divide by 4: at W = 360
  (30 windows) it raises ValueError, as the JAX script does, and the card
  runs it at W = 336 (28 windows), the first 336 lon columns of the same x.

The inputs are the JAX script's draws from ``np.random.default_rng(0)``, the
weights in nn.Linear's (out, in) layout (the transpose of its Dense layout).
Each variant is held against its plain version (the kernel bounds of
tests/test_torch_gpu.py) and against ``shipped`` with the JAX script's metric
(max|d| <= 0.05), then timed (ms per call, CUDA events). One JSON line per
variant, then ``{"attn_fwd_ab_ms": {...}, "device_kind": ...}``.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, Sequence

import numpy as np
import torch

from pangu_tpu_torch.ops import fused_block_attention as fba
from pangu_tpu_torch.ops.fused_block_attention import dense_reference, dot_f32
from pangu_tpu_torch.scripts.ab_common import bound, compare, cuda_device, cuda_times_ms, emit

# the outer-stage geometry (geometry.compute_geometry on the pretrained config)
B, Z, HP, W, C = 1, 8, 186, 360, 192
WINDOW = (2, 6, 12)
HEADS = 6
W_QUAD = 336  # 28 lon windows: quad's packing needs a multiple of 4
VARIANTS = ("shipped", "batched", "dbl", "quad")
NW = {"shipped": 1, "batched": 1, "dbl": 2, "quad": 4}
NEG = -1e9
PARITY_TOL = 0.05  # max|d| against shipped, the JAX script's bound
#: kernel launches per fat-window variant in this process (shipped: K2's counter)
LAUNCHES: Dict[str, int] = dict.fromkeys(VARIANTS[1:], 0)


def check_variant(name: str) -> None:
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; choose from {VARIANTS}")


def scale(c: int = C, heads: int = HEADS) -> float:
    return (c // heads) ** -0.5


def interleave_bias(bias: torch.Tensor, nw: int, ww: int) -> torch.Tensor:
    """(nT, heads, t, t) earth bias -> (nT, heads, nw t, nw t) bias for the
    interleaved nw-window token order of a contiguous (wz, wh, nw ww, C)
    slice, with cross-window pairs set to -1e9; built on bias's device."""
    t = bias.shape[-1]
    idx = torch.arange(nw * t, device=bias.device)
    zh, r = idx // (nw * ww), idx % (nw * ww)
    win, tok = r // ww, zh * ww + r % ww
    out = bias[:, :, tok[:, None], tok[None, :]].float()
    same = win[:, None] == win[None, :]
    return torch.where(same, out, torch.full((), NEG, dtype=torch.float32, device=bias.device))


def make_args(device, geometry=None, seed: int = 0):
    """The JAX script's draws, in its order: (x, wqkv, bqkv, wproj, bproj)
    bf16 with nn.Linear-layout weights, and the (nT, heads, 144, 144) f32
    earth bias."""
    b, z, hp, w, c, heads = geometry or (B, Z, HP, W, C, HEADS)
    wz, wh, ww = WINDOW
    t = wz * wh * ww
    rng = np.random.default_rng(seed)
    bias = (rng.standard_normal(((z // wz) * (hp // wh), heads, t, t)) * 0.01).astype(np.float32)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)

    x = bf(rng.standard_normal((b, z, hp, w, c)) * 0.1)
    wqkv = bf(rng.standard_normal((c, 3 * c)) * 0.05).t().contiguous()
    bqkv = bf(rng.standard_normal((1, 3 * c)) * 0.05).reshape(-1)
    wproj = bf(rng.standard_normal((c, c)) * 0.05).t().contiguous()
    bproj = bf(rng.standard_normal((1, c)) * 0.05).reshape(-1)
    return (x, wqkv, bqkv, wproj, bproj), torch.from_numpy(bias).to(device)


def _check(variant: str, x, bias_nw, heads: int) -> None:
    check_variant(variant)
    nw = NW[variant]
    b, z, hp, w, c = x.shape
    wz, wh, ww = WINDOW
    if w % ww or (w // ww) % nw:
        raise ValueError(f"{variant}: {w // ww} lon-windows not divisible by the {nw}-window "
                         f"packing")
    want = ((z // wz) * (hp // wh), heads, nw * wz * wh * ww, nw * wz * wh * ww)
    if tuple(bias_nw.shape) != want or bias_nw.dtype != torch.float32:
        raise ValueError(f"{variant} takes a {want} f32 bias table, got "
                         f"{tuple(bias_nw.shape)} {bias_nw.dtype}")


def fat_attention_reference(variant: str, x, wqkv, bqkv, wproj, bproj, bias_nw,
                            heads: int = HEADS) -> torch.Tensor:
    """Plain PyTorch version of a variant, the Pallas body's rounding points
    (qkv, the probabilities, the attention output in x's dtype; scores and
    softmax f32), in chunks of window types to bound its memory."""
    _check(variant, x, bias_nw, heads)
    dt, nw = x.dtype, NW[variant]
    b, z, hp, w, c = x.shape
    wz, wh, ww = WINDOW
    zn, hn, wfn, d = z // wz, hp // wh, w // (ww * nw), c // heads
    tn = nw * wz * wh * ww
    xw = x.reshape(b, zn, wz, hn, wh, wfn, nw * ww, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    xw = xw.reshape(b, zn * hn, wfn, tn, c)
    chunk = max(1, 2 ** 30 // (b * wfn * heads * tn * tn * 4))
    ys = []
    for t0 in range(0, zn * hn, chunk):
        xc = xw[:, t0:t0 + chunk]
        nc = xc.shape[1]
        qkv = (dot_f32(xc, wqkv.t()) + bqkv.float()).to(dt)
        q, k, v = qkv.reshape(b, nc, wfn, tn, 3, heads, d).permute(4, 0, 1, 2, 5, 3, 6)
        s = dot_f32(q, k.transpose(-1, -2)) * scale(c, heads) + bias_nw[t0:t0 + nc, None]
        p = torch.softmax(s, dim=-1).to(dt)
        del s
        a = dot_f32(p, v).to(dt).permute(0, 1, 2, 4, 3, 5).reshape(b, nc, wfn, tn, c)
        ys.append(dense_reference(a, wproj, bproj))
    y = torch.cat(ys, 1).reshape(b, zn, hn, wfn, wz, wh, nw * ww, c)
    return y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, z, hp, w, c)


def _library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library("bench_attn_fwd_ab.cu")
    if lib.pangu_attn_fat_fwd.argtypes is None:
        lib.pangu_attn_fat_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                                           + [ctypes.c_float, ctypes.c_void_p])
        lib.pangu_attn_fat_fwd.restype = ctypes.c_int
    return lib


def fat_attention(variant: str, x, wqkv, bqkv, wproj, bproj, bias_nw,
                  heads: int = HEADS) -> torch.Tensor:
    """A fat-window variant (``batched``, ``dbl``, ``quad``): the CUDA kernel
    on a CUDA tensor (or an error), the plain version on a CPU tensor."""
    if variant == "shipped":
        raise ValueError("shipped is K2: use variant_call")
    _check(variant, x, bias_nw, heads)
    if x.device.type == "cpu":
        return fat_attention_reference(variant, x, wqkv, bqkv, wproj, bproj, bias_nw, heads)
    tensors = (x, wqkv, bqkv, wproj, bproj, bias_nw)
    c = x.shape[-1]
    if x.dtype != torch.bfloat16 or c != 192 or heads != 6:
        raise ValueError(f"the CUDA kernel takes bf16 x with C = 192 and 6 heads, got "
                         f"{x.dtype}, C={c}, heads={heads}")
    if any(not t.is_contiguous() or t.data_ptr() % 32 for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous 32-byte aligned tensors")
    if (x.numel() // c) % 64:
        raise ValueError(f"the CUDA kernel takes a multiple of 64 token rows, got {x.numel() // c}")
    lib = _library()
    attn, out = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pangu_attn_fat_fwd(*[t.data_ptr() for t in tensors], attn.data_ptr(),
                                    out.data_ptr(), NW[variant], *x.shape, heads, *WINDOW,
                                    ctypes.c_float(scale(c, heads)), stream)
    if rc != 0:
        raise RuntimeError(f"bench_attn_fwd_ab {variant} CUDA launch failed: cudaError_t {rc}")
    LAUNCHES[variant] += 1
    return out


def variant_call(variant: str, x, wqkv, bqkv, wproj, bproj, bias_nw,
                 heads: int = HEADS) -> torch.Tensor:
    """One forward call of ``variant`` (``bias_nw``: the earth bias for
    ``shipped``/``batched``, the interleaved table for ``dbl``/``quad``)."""
    if variant != "shipped":
        return fat_attention(variant, x, wqkv, bqkv, wproj, bproj, bias_nw, heads)
    with torch.no_grad():
        return fba.fused_block_attention(x, wqkv, bqkv, wproj, bproj, bias_nw, None, None, None,
                                         WINDOW, heads, scale(x.shape[-1], heads))


def plain_call(variant: str, x, wqkv, bqkv, wproj, bproj, bias_nw, heads: int = HEADS):
    """The plain PyTorch version of ``variant``."""
    if variant != "shipped":
        return fat_attention_reference(variant, x, wqkv, bqkv, wproj, bproj, bias_nw, heads)
    return fba.fused_block_attention_reference(x, wqkv, bqkv, wproj, bproj, bias_nw, None,
                                               WINDOW, heads, scale(x.shape[-1], heads))


def fwd_bound(variant: str, x, n_types: int, heads: int = HEADS) -> dict:
    """Bound of one call: the product FLOP the result needs, 8 r C^2 + 4 r 144
    C (a fat window's cross-window pairs have probability 0 and add nothing),
    or x in and out, the variant's bias table (NW 144 wide) and the weights
    once."""
    rows, c = x.numel() // x.shape[-1], x.shape[-1]
    t = WINDOW[0] * WINDOW[1] * WINDOW[2]
    tn = NW[variant] * t
    return bound(8 * rows * c * c + 4 * rows * t * c,
                 4 * rows * c + n_types * heads * tn * tn * 4 + (4 * c * c + 4 * c) * 2)


def variant_args(variant: str, base, bias, tables: dict):
    """(x, wqkv, bqkv, wproj, bproj, bias table) of ``variant`` at the card's
    width: quad on the first W_QUAD lon columns."""
    x = base[0] if NW[variant] < 4 else base[0][..., :W_QUAD, :].contiguous()
    nw = NW[variant]
    if nw not in tables:
        tables[nw] = bias if nw == 1 else interleave_bias(bias, nw, WINDOW[2])
    return (x, *base[1:], tables[nw])


def run(variants: Sequence[str] = VARIANTS, checked: bool = True, device=None) -> Dict[str, dict]:
    """Each variant on the card: (checked) then timed, ms per call."""
    for v in variants:
        check_variant(v)
    dev = device or cuda_device()
    base, bias = make_args(dev)
    tables, ship_cache, out = {}, {}, {}
    for v in variants:
        args = variant_args(v, base, bias, tables)
        res = compare_variant(v, args, bias, ship_cache) if checked else {}
        res.update(ms=cuda_times_ms(lambda: variant_call(v, *args)),
                   plain_ms=cuda_times_ms(lambda: plain_call(v, *args), n=3, warmup=1),
                   library_ms=None, width=args[0].shape[3],
                   **fwd_bound(v, args[0], bias.shape[0]))
        out[v] = res
    return out


def compare_variant(variant: str, args, bias, ship_cache: dict) -> dict:
    """The kernel against its plain version (phase-3 bounds) and against
    ``shipped`` on the same x with the JAX script's metric (max|d| <= 0.05)."""
    got = variant_call(variant, *args)
    torch.cuda.synchronize()
    res = compare(got, plain_call(variant, *args))
    w = args[0].shape[3]
    if w not in ship_cache:
        ship_cache[w] = variant_call("shipped", *args[:5], bias)
    res["vs_shipped"] = (got.float() - ship_cache[w].float()).abs().max().item()
    res["ok"] = res["ok"] and res["vs_shipped"] <= PARITY_TOL
    return res


def main(argv: Sequence[str]) -> int:
    variants = list(argv) or list(VARIANTS)
    for v in variants:  # refuse before any device minute is spent
        check_variant(v)
    res = run(variants)
    for v, r in res.items():
        emit({v: r})
    emit({"attn_fwd_ab_ms": {v: round(r["ms"], 4) for v, r in res.items()},
          "device_kind": torch.cuda.get_device_name(0)})
    failed = [v for v, r in res.items() if not r["ok"]]
    if failed:
        raise AssertionError(f"{failed} disagree with their plain versions or with shipped")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
