"""A/B of attention-backward schedules on one CUDA card (port of
``scripts/bench_attn_bwd_ab.py``).

    python -m pangu_tpu_torch.scripts.bench_attn_bwd_ab [variant ...]

Both variants compute K3's function, mask-free, on the outer-stage grid (1,
8, 186, 360, 192), 6 heads, window (2, 6, 12): from the cotangent g of
``y = attn(x) @ Wproj^T + bproj``, (dx, dwqkv, dbqkv, dwproj, dbproj, dbias),
weights in nn.Linear's (out, in) layout:

* ``shipped``: the port's K3, ``ops.fused_block_attention.fused_block_attention_bwd``:
  the acc and dqkv slabs, then the weight grads as row-split products over
  all rows, rounded to bf16 (as the JAX ``_shipped_call`` returns them);
* ``local_accum``: K3's attention kernel with the weight grads accumulated
  in f32 on chip, per (window type, head) across its windows, one partial per
  (type, head) summed in a fixed order (``csrc/bench_attn_bwd_ab.cu``); the
  weight and bias grads f32, as the JAX variants return them.

The other JAX variants are refused (:data:`REFUSED`, ValueError before
anything runs). The inputs are the JAX script's draws from
``np.random.default_rng(0)``. Each variant is held against its plain version
(the kernel bounds of tests/test_torch_gpu.py, all six outputs), ``local_accum``
against ``shipped`` with the JAX script's metric (max of |d dx| and |d dwqkv|
/ max|dwqkv| <= 0.05) and against itself (the same bits on a second run),
then timed (ms per call, CUDA events). One JSON line per variant, then
``{"attn_bwd_ab_ms": {...}, "device_kind": ...}``.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, Sequence

import numpy as np
import torch

from pangu_tpu_torch.ops import fused_block_attention as fba
from pangu_tpu_torch.scripts.ab_common import bound, compare, cuda_device, cuda_times_ms, emit

# the outer-stage geometry (geometry.compute_geometry on the pretrained config)
B, Z, HP, W, C = 1, 8, 186, 360, 192
WINDOW = (2, 6, 12)
HEADS = 6
VARIANTS = ("shipped", "local_accum")
NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
PARITY_TOL = 0.05  # the JAX script's bound against shipped
#: variants of the JAX script that the port does not run, with the reason
REFUSED = {
    "fat_wgrad": "the schedule K3 (shipped) already runs: the weight grads as deep products "
                 "over the staged slabs after the window loop",
    "value_all": "trades Mosaic's 32-lane strided VMEM stores for values, which has no "
                 "meaning on Hopper",
    "value_fat": "value_all with the fat weight grads: Mosaic's strided stores have no "
                 "meaning on Hopper, and the fat weight grads are shipped",
    "pair": "packs 2 lon windows to fill the 128-row matrix unit; the 16-row wmma tiles "
            "already divide 144",
    "tri": "packs 3 lon windows to fill the 128-row matrix unit; the 16-row wmma tiles "
           "already divide 144",
    "pair_fat": "pair with the fat weight grads: the packing fills the TPU's 128-row tiles, "
                "which Hopper's 16-row tiles do not need",
    "tri_fat": "tri with the fat weight grads: the packing fills the TPU's 128-row tiles, "
               "which Hopper's 16-row tiles do not need",
}
#: kernel launches of local_accum in this process (shipped: K3's counter)
LAUNCHES = 0


def check_variant(name: str) -> None:
    """Raise ValueError for a variant the port does not run (with the
    reason) or does not know."""
    if name in REFUSED:
        raise ValueError(f"variant {name!r} is not run by the port: {REFUSED[name]}")
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; choose from {VARIANTS}")


def scale(c: int = C, heads: int = HEADS) -> float:
    return (c // heads) ** -0.5


def make_args(device, geometry=None, seed: int = 0):
    """The JAX script's draws, in its order: x, g (bf16), wqkv, bqkv, wproj
    (bf16, nn.Linear layout), the (nT, heads, 144, 144) f32 earth bias."""
    b, z, hp, w, c, heads = geometry or (B, Z, HP, W, C, HEADS)
    wz, wh, ww = WINDOW
    t = wz * wh * ww
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)

    x = bf(rng.standard_normal((b, z, hp, w, c)) * 0.1)
    g = bf(rng.standard_normal((b, z, hp, w, c)) * 0.1)
    wqkv = bf(rng.standard_normal((c, 3 * c)) * 0.05).t().contiguous()
    bqkv = bf(rng.standard_normal((1, 3 * c)) * 0.05).reshape(-1)
    wproj = bf(rng.standard_normal((c, c)) * 0.05).t().contiguous()
    bias = torch.from_numpy((rng.standard_normal(((z // wz) * (hp // wh), heads, t, t)) * 0.01)
                            .astype(np.float32)).to(device)
    return x, g, wqkv, bqkv, wproj, bias


def plain_call(variant: str, x, g, wqkv, bqkv, wproj, bias, heads: int = HEADS):
    """The plain PyTorch version of ``variant``: K3's, with the weight grads
    rounded (shipped) or f32 (local_accum)."""
    check_variant(variant)
    return fba.fused_block_attention_bwd_reference(x, wqkv, bqkv, wproj, bias, None, g, WINDOW,
                                                   heads, scale(x.shape[-1], heads),
                                                   round_grads=variant == "shipped")


def _library() -> ctypes.CDLL:
    from pangu_tpu_torch.ops._build import load_library

    lib = load_library("bench_attn_bwd_ab.cu")
    if lib.pangu_attn_bwd_local.argtypes is None:
        lib.pangu_attn_bwd_local_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.pangu_attn_bwd_local_scratch.restype = ctypes.c_longlong
        lib.pangu_attn_bwd_local.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                                             + [ctypes.c_float, ctypes.c_void_p])
        lib.pangu_attn_bwd_local.restype = ctypes.c_int
    return lib


def local_accum(x, g, wqkv, bqkv, wproj, bias, heads: int = HEADS):
    """``local_accum``: the CUDA kernel on CUDA tensors (or an error), the
    plain version on CPU tensors."""
    if x.device.type == "cpu":
        return plain_call("local_accum", x, g, wqkv, bqkv, wproj, bias, heads)
    global LAUNCHES
    tensors = (x, g, wqkv, bqkv, wproj, bias)
    b, z, hp, w, c = x.shape
    rows, n_types = x.numel() // c, bias.shape[0]
    if x.dtype != torch.bfloat16 or g.dtype != x.dtype or c != 192 or heads != 6:
        raise ValueError(f"the CUDA kernel takes bf16 x and g with C = 192 and 6 heads, got "
                         f"{x.dtype}/{g.dtype}, C={c}, heads={heads}")
    if g.shape != x.shape or tuple(bias.shape[1:]) != (heads, 144, 144) or rows % 64:
        raise ValueError("local_accum takes g of x's shape, a (nT, heads, 144, 144) bias and a "
                         "multiple of 64 token rows")
    if any(not t.is_contiguous() or t.data_ptr() % 32 for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous 32-byte aligned tensors")
    lib = _library()
    dev = x.device
    f32 = torch.float32
    dqkv = torch.empty(rows, 3 * c, dtype=x.dtype, device=dev)
    acc = torch.empty(rows, c, dtype=x.dtype, device=dev)
    scratch = torch.empty(lib.pangu_attn_bwd_local_scratch(c, n_types), dtype=f32, device=dev)
    grads = (torch.empty_like(x), torch.empty(3 * c, c, dtype=f32, device=dev),
             torch.empty(3 * c, dtype=f32, device=dev), torch.empty(c, c, dtype=f32, device=dev),
             torch.empty(c, dtype=f32, device=dev), torch.empty_like(bias))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pangu_attn_bwd_local(*[t.data_ptr() for t in tensors + (dqkv, acc, scratch)
                                        + grads],
                                      b, z, hp, w, c, heads, *WINDOW,
                                      ctypes.c_float(scale(c, heads)), stream)
    if rc != 0:
        raise RuntimeError(f"bench_attn_bwd_ab local_accum CUDA launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return grads


def variant_call(variant: str, x, g, wqkv, bqkv, wproj, bias, heads: int = HEADS):
    """One backward call of ``variant``: the six grads."""
    check_variant(variant)
    if variant == "local_accum":
        return local_accum(x, g, wqkv, bqkv, wproj, bias, heads)
    return fba.fused_block_attention_bwd(x, wqkv, bqkv, wproj, bias, None, g, WINDOW, heads,
                                         scale(x.shape[-1], heads))


def parity(got, ref) -> float:
    """The JAX script's metric: max(max|d dx|, max|d dwqkv| / max|dwqkv ref|)."""
    dw = ref[1].float()
    return max((got[0].float() - ref[0].float()).abs().max().item(),
               (got[1].float() - dw).abs().max().item() / max(dw.abs().max().item(), 1e-6))


def bwd_bound(x, n_types: int, heads: int = HEADS) -> dict:
    """K3's bound without the mask: 22 r C^2 + 12 r 144 C product FLOP, or x,
    g and dx, the bias and dbias, the weights and their grads once."""
    rows, c = x.numel() // x.shape[-1], x.shape[-1]
    return bound(22 * rows * c * c + 12 * rows * 144 * c,
                 6 * rows * c + 2 * n_types * heads * 144 * 144 * 4 + 2 * (4 * c * c + 4 * c) * 2)


def compare_variant(variant: str, args, ship_cache: dict) -> dict:
    """All six outputs against the plain version (phase-3 bounds);
    local_accum also against shipped (the JAX metric) and its own second run
    (the same bits)."""
    got = variant_call(variant, *args)
    torch.cuda.synchronize()
    ref = plain_call(variant, *args)
    outs = {n: compare(a, b) for n, a, b in zip(NAMES, got, ref)}
    del ref
    res = dict(outputs=outs, ok=all(o["ok"] for o in outs.values()),
               max_abs_err=max(o["max_abs"] for o in outs.values()))
    if variant == "local_accum":
        if "ship" not in ship_cache:
            ship_cache["ship"] = variant_call("shipped", *args)
        res["vs_shipped"] = parity(got, ship_cache["ship"])
        again = variant_call(variant, *args)
        res["same_bits"] = all(torch.equal(a, b) for a, b in zip(got, again))
        res["ok"] = res["ok"] and res["vs_shipped"] <= PARITY_TOL and res["same_bits"]
    return res


def run(variants: Sequence[str] = VARIANTS, checked: bool = True, device=None) -> Dict[str, dict]:
    """Each variant on the card: (checked) then timed, ms per call."""
    for v in variants:
        check_variant(v)
    dev = device or cuda_device()
    args = make_args(dev)
    ship_cache, out = {}, {}
    for v in variants:
        res = compare_variant(v, args, ship_cache) if checked else {}
        res.update(ms=cuda_times_ms(lambda: variant_call(v, *args)),
                   plain_ms=cuda_times_ms(lambda: plain_call(v, *args), n=3, warmup=1),
                   library_ms=None, **bwd_bound(args[0], args[5].shape[0]))
        out[v] = res
    return out


def main(argv: Sequence[str]) -> int:
    variants = list(argv) or list(VARIANTS)
    for v in variants:  # refuse before any device minute is spent
        check_variant(v)
    res = run(variants)
    for v, r in res.items():
        emit({v: r})
    emit({"attn_bwd_ab_ms": {v: round(r["ms"], 4) for v, r in res.items()},
          "device_kind": torch.cuda.get_device_name(0)})
    failed = [v for v, r in res.items() if not r["ok"]]
    if failed:
        raise AssertionError(f"{failed} disagree with their plain versions or with shipped")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
