"""Device time of the kernel A/B variants, on one CUDA card: S1's fat-window
forward (``bench_attn_fwd_ab``: ``shipped`` K2, ``batched``, ``dbl``,
``quad``) and S2's on-chip weight-grad backward (``bench_attn_bwd_ab``:
``shipped`` K3, ``local_accum``), at the scripts' outer-stage shapes and
draws, and S3's tensor-core micro-bench (``bench_mxu_micro``: ``loop``,
``blockdiag``, ``qblockdiag``, ``loop_int8``), one timed call of ``SWEEPS``
sweeps over its seeded windows each.

    PYTHONPATH=TREE python pangu_tpu_torch/scripts/profile_attn_ab.py [TREE]
        [--parts fwd bwd mxu]

Run as a file with ``PYTHONPATH`` naming the checkout to time, so that one
call can time checkouts that lack this script in turn (old, new, new, old);
TREE (default ".") names it in the output. For each variant: the name and
device ms of each kernel of one call (``profile_bwd_split.kernel_ms``, the
mean over 5 calls under torch.profiler), their sum, and the wrapper's ms
(CUDA events around the call, ``ab_common.cuda_times_ms``, host time
included); for S3 also both per sweep. Prints one JSON line with the card's
name and power limit and a key per part.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from pangu_tpu_torch.ops import _build
from pangu_tpu_torch.scripts import bench_attn_bwd_ab as bwd
from pangu_tpu_torch.scripts import bench_attn_fwd_ab as fwd
from pangu_tpu_torch.scripts import bench_mxu_micro as micro
from pangu_tpu_torch.scripts.ab_common import cuda_times_ms
from pangu_tpu_torch.scripts.profile_bwd_split import kernel_ms


def timed(fn) -> dict:
    """Each kernel's device ms, their sum and the wrapper's ms of fn()."""
    kernels = kernel_ms(fn, n=5)
    return {"kernels": kernels, "device_ms": sum(ms for _, ms in kernels),
            "wrapper_ms": cuda_times_ms(fn)}


def mxu_part(dev, timer=timed) -> dict:
    """Each S3 variant's timed call (``SWEEPS`` sweeps over the seeded
    windows, its split and repeat), through ``timer``; the sums also per
    sweep."""
    qkv, qkv8 = micro.make_inputs(dev)
    out = {}
    for v in micro.VARIANTS:
        x = qkv8 if v == "loop_int8" else qkv
        r = timer(lambda: micro.mxu_micro(v, x, micro.SWEEPS))
        r.update(sweeps=micro.SWEEPS, device_ms_per_sweep=r["device_ms"] / micro.SWEEPS,
                 wrapper_ms_per_sweep=r["wrapper_ms"] / micro.SWEEPS)
        out[v] = r
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".")
    ap.add_argument("--parts", nargs="+", choices=("fwd", "bwd", "mxu"),
                    default=["fwd", "bwd", "mxu"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA card")
    dev = torch.device("cuda:0")
    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = {"tree": args.tree, "card": card}
    if "fwd" in args.parts:
        out["fwd"] = {}
        base, bias = fwd.make_args(dev)
        tables = {}
        with torch.no_grad():
            for v in fwd.VARIANTS:
                a = fwd.variant_args(v, base, bias, tables)
                out["fwd"][v] = timed(lambda: fwd.variant_call(v, *a))
        del base, bias, tables, a
        torch.cuda.empty_cache()
    if "bwd" in args.parts:
        b_args = bwd.make_args(dev)
        out["bwd"] = {v: timed(lambda: bwd.variant_call(v, *b_args)) for v in bwd.VARIANTS}
        del b_args
        torch.cuda.empty_cache()
    if "mxu" in args.parts:
        out["mxu"] = mxu_part(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
