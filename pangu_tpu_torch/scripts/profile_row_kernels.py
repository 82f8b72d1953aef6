"""Device time of the row-engine and window-attention kernels, on one CUDA
card: the MLP tail K6, the row pass of its backward K7, the two kernels of the
inference block K1 (window attention, token tail) and the two of the
training attention K2 (window attention, out-projection), at the flagship
outer and inner stage shapes, K1 and K2 unshifted and shifted.

    PYTHONPATH=TREE python pangu_tpu_torch/scripts/profile_row_kernels.py [TREE]

Seeded inputs (``profile_bwd_split.stage_inputs``; shifted blocks with the
real shift mask); each time is the mean over a few calls under
torch.profiler (``profile_bwd_split.kernel_ms``). The kernels are those of the
checkout TREE first on ``PYTHONPATH``, so one call can time several trees in
turn (an A/B: old, new, new, old); TREE (default ".") names it in the
output. Prints one JSON line: per stage, the name and device ms of K6's
kernel and of K7's first kernel (its row pass), and of each kernel of one K1
and one K2 call, unshifted and shifted.
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
from pangu_tpu_torch.ops import fused_mlp as fmlp
from pangu_tpu_torch.scripts.profile_bwd_split import kernel_ms, stage_inputs


def row_kernels(stage, c: int, heads: int, dev) -> dict:
    """K6, K7's row pass and K1's and K2's kernels at one stage shape."""
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
        label = "shifted" if shifted else "unshifted"
        with torch.no_grad():
            if not shifted:  # the row kernels do not see the shift
                res["K6"] = kernel_ms(lambda: fmlp.fused_mlp_postnorm(x2, *inp["mlp"],
                                                                     inp["s"][:, None]), n=5)[0]
                res["K7 row pass"] = kernel_ms(lambda: fmlp.fused_mlp_postnorm_bwd(
                    x2, g2, *inp["mlp"], inp["s"]))[0]
            res[f"K1 {label}"] = kernel_ms(lambda: fba.fused_earth_block(*k1), n=5)
            res[f"K2 {label}"] = kernel_ms(lambda: fba.fused_block_attention(*k2), n=5)
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
