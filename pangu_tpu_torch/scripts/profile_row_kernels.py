"""Device time of the forecast and default train-step kernels, on one CUDA
card: the MLP tail K6 and its backward K7, the raw MLP K8, the post-norm
residual K4 and its backward K5, the two kernels of the inference block K1
(window attention, token tail), the two of the training attention K2 (window
attention, out-projection) and those of its backward K3, at the flagship
outer and inner stage shapes, K1-K3 unshifted and shifted.

    PYTHONPATH=TREE python pangu_tpu_torch/scripts/profile_row_kernels.py [TREE]

Seeded inputs (``profile_bwd_split.stage_inputs``; shifted blocks with the
real shift mask); each time is the mean over a few calls under
torch.profiler (``profile_bwd_split.kernel_ms``). The kernels are those of the
checkout TREE first on ``PYTHONPATH``, so one call can time several trees in
turn (an A/B: old, new, new, old); TREE (default ".") names it in the
output. Prints one JSON line: per stage, the name and device ms of each
kernel of one call of K1-K8 (K1-K3 unshifted and shifted; K4 and K5 with a
per-row scale).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from pangu_tpu_torch import pangu_pretrain
from pangu_tpu_torch.geometry import compute_geometry
from pangu_tpu_torch.ops import _build
from pangu_tpu_torch.ops import fused_block_attention as fba
from pangu_tpu_torch.ops import fused_epilogue as fep
from pangu_tpu_torch.ops import fused_mlp as fmlp
from pangu_tpu_torch.scripts.profile_bwd_split import kernel_ms, stage_inputs


def row_kernels(stage, c: int, heads: int, dev) -> dict:
    """The kernels of K1-K8 at one stage shape."""
    res = {}
    for shifted in (False, True):
        inp = stage_inputs(stage, c, heads, shifted, dev, seed=45)
        x2, g2 = inp["x"].reshape(-1, c), inp["gy"].reshape(-1, c)
        wqkv, bqkv, wproj, bias, mask = inp["attn"]
        w1, b1, w2, b2, ln_s, ln_b = inp["mlp"]
        bproj = bqkv[:c].contiguous()
        k1 = (inp["x"], wqkv, bqkv, wproj, bproj, bias, mask, ln_s, ln_b,
              w1, b1, w2, b2, ln_s, ln_b, *inp["statics"])
        k2 = (inp["x"], wqkv, bqkv, wproj, bproj, bias, mask, None, None, *inp["statics"])
        k3 = (inp["x"], wqkv, bqkv, wproj, bias, mask, inp["gy"], *inp["statics"])
        label = "shifted" if shifted else "unshifted"
        with torch.no_grad():
            if not shifted:  # the row kernels do not see the shift
                res["K4"] = kernel_ms(lambda: fep.fused_residual_postnorm(
                    x2, g2, ln_s, ln_b, inp["s"][:, None]), n=5)
                res["K5"] = kernel_ms(lambda: fep.fused_residual_postnorm_bwd(
                    x2, g2, ln_s, ln_b, inp["s"]), n=5)
                res["K6"] = kernel_ms(lambda: fmlp.fused_mlp_postnorm(x2, *inp["mlp"],
                                                                     inp["s"][:, None]), n=5)
                res["K8"] = kernel_ms(lambda: fmlp.fused_mlp(x2, w1, b1, w2, b2), n=5)
                res["K7"] = kernel_ms(lambda: fmlp.fused_mlp_postnorm_bwd(
                    x2, g2, *inp["mlp"], inp["s"]))
            res[f"K1 {label}"] = kernel_ms(lambda: fba.fused_earth_block(*k1), n=5)
            res[f"K2 {label}"] = kernel_ms(lambda: fba.fused_block_attention(*k2), n=5)
            res[f"K3 {label}"] = kernel_ms(lambda: fba.fused_block_attention_bwd(*k3))
        del inp
        torch.cuda.empty_cache()
    return res


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA card")
    dev = torch.device("cuda:0")
    _build.build_all()
    g = compute_geometry(pangu_pretrain(24).model)
    out = {"tree": args.tree}
    for name, stage, c, heads in (("outer", g.outer, 192, 6), ("inner", g.inner, 384, 12)):
        out[name] = row_kernels(stage, c, heads, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
