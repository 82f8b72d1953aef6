"""Where the two costliest backward kernels spend their time, on one CUDA card.

    python -m pangu_tpu_torch.scripts.profile_bwd_split [--cuts TREE]

For the MLP-tail backward K7 (``fused_mlp_postnorm_bwd``) and the attention
backward K3 (``fused_block_attention_bwd``) at the flagship outer and inner
stage shapes, with seeded inputs: the device time of every kernel that one
call launches, in launch order (torch.profiler, the mean over 3 calls), and
beside the weight-grad products one ``torch.mm`` of the same product (bf16
in, f32 out; the dx product bf16 out), a yardstick the port never calls.

``--cuts TREE``: also time the attention kernel of K3 with one phase cut out,
phase by phase, in throwaway builds of ``TREE/pangu_tpu_torch/csrc`` written
to ``build/cuts/`` (their outputs are wrong on purpose; the phase's cost is
the full kernel's time less the cut one's). The cuts are text edits of the
kernel that K3 launches in TREE (``PHASE_CUTS``: the earlier schedule,
``attention_bwd_kernel<false>``, or the register-resident one); a
tree with neither is refused. For another tree than this one, run the
script with that tree first on ``PYTHONPATH``.

Prints one JSON line per stage and shape, then ``{"device_kind": ...}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

from pangu_tpu_torch import pangu_pretrain
from pangu_tpu_torch.geometry import compute_geometry
from pangu_tpu_torch.model.attention import shift_attention_mask
from pangu_tpu_torch.ops import _build
from pangu_tpu_torch.ops import fused_block_attention as fba
from pangu_tpu_torch.ops import fused_mlp as fmlp
from pangu_tpu_torch.scripts.ab_common import cuda_times_ms

def _guard(text: str, k: int) -> Tuple[str, str]:
    """The edit that skips the statement starting at ``text`` under cut k."""
    body = text.lstrip(" ")
    return text, text[:len(text) - len(body)] + f"if (CUT != {k}) " + body


def _bound(text: str, old: str, k: int) -> Tuple[str, str]:
    """The edit that makes the loop ``for (... < old; ...)`` starting at
    ``text`` run no iteration under cut k."""
    return text, text.replace(old, f"(CUT == {k} ? 0 : {old})", 1)


#: K3's attention kernel as launched by block_attention.cu -> phase -> edits
#: (text of the kernel, its replacement, which cuts the phase under CUT)
PHASE_CUTS: Dict[str, Dict[str, List[Tuple[str, str]]]] = {
    # the earlier per-(type, head) schedule, wmma fragments
    "attention_bwd_kernel<false><<<": {
        "recompute q|k|v and dO": [
            _guard("      pipelined(\n          C / KC, stage0, stage0 + B_STAGE_ELEMS,", 1)],
        "scores and softmax": [
            ("      // ---- scores of the warp's query rows, f32 softmax: p f32 in S, bf16 in P\n"
             "      {", "      if (CUT != 2) {"),
            _guard("      for (int r = 0; r < 16; ++r) {\n        float v[PER_LANE];", 2)],
        "P v and the acc store": [(
            "      if (!DO_GIVEN) {\n        FragC o[2];",
            "      if (!DO_GIVEN && CUT != 3) {\n        FragC o[2];")],
        "two dP sweeps and the dbias update": [(
            "then dS (dbias, bf16 dS)\n      {",
            "then dS (dbias, bf16 dS)\n      if (CUT != 4) {")],
        "dq, dk, dv (with the dqkv stores)": [(
            "      // ---- dq (query rows), dk and dv (key rows) of tile `warp`\n      {",
            "      if (CUT != 5) {")],
        "the dqkv slab stores": [_guard(
            "        for (int seg = 0; seg < 3; ++seg) {\n          __align__(16) bf16 t16", 6)],
    },
    # the register-resident schedule, mma.sync
    "attention_bwd_regs_kernel<<<": {
        "recompute q|k|v and dO": [
            _guard("      pipelined(\n          C / K3_KC, stage0, stage0 + K3_STAGE_ELEMS,", 1)],
        "S = q k^T": [_bound("        for (int nb = 0; nb < T / 16; ++nb) {\n#pragma unroll\n"
                             "          for (int e = 0; e < 4; ++e) s[2 * nb][e]", "T / 16", 2)],
        "softmax (bias, mask, P rows)": [_bound(
            "      for (int h = 0; h < 2; ++h) {  // rows gq and gq + 8", "2", 3)],
        "O = P v, the acc store and D": [
            _bound("        for (int kb = 0; kb < T / 16; ++kb) {\n          const uint32_t pa[4]",
                   "T / 16", 4),
            _bound("        for (int h = 0; h < 2; ++h) {\n"
                   "          const int r = q0 + gq + 8 * h;", "2", 4)],
        "dP, dS, dbias and dq": [_bound(
            "        for (int nb = 0; nb < T / 16; ++nb) {\n          float dp[2][4] = {};",
            "T / 16", 5)],
        "dk and dv": [_bound("      for (int qb = 0; qb < T / 16; ++qb) {", "T / 16", 6)],
        "the dqkv slab stores": [_bound(
            "      for (int h = 0; h < 2; ++h) {\n        bf16* row = dqkv", "2", 7)],
    },
}


def kernel_ms(fn: Callable[[], object], n: int = 3) -> List[Tuple[str, float]]:
    """(name, device ms) of each kernel that one call of ``fn`` launches, in
    launch order: the mean over n calls under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    per = len(ev) // n
    return [(_short(ev[i].name),
             sum(ev[j * per + i].time_range.elapsed_us() for j in range(n)) / n / 1e3)
            for i in range(per)]


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    if "namespace)::" in name:
        name = name.split("namespace)::", 1)[1]
    return name.split("(")[0]


def stage_inputs(stage, c: int, heads: int, shifted: bool, dev, seed: int) -> dict:
    """Seeded bf16 inputs of K7 and K3 at one stage's full shape."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, dtype=bf, mean=0.0, std=1.0):
        return (mean + std * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    x = rn(1, stage.z, stage.h_pad, stage.w, c)
    rows = x.numel() // c
    mask = torch.from_numpy(shift_attention_mask(stage)).to(dev) if shifted else None
    return dict(
        x=x, gy=rn(*x.shape), rows=rows, wide=rn(rows, 4 * c),
        mlp=(rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02), rn(c, 4 * c, std=(4 * c) ** -0.5),
             rn(c, std=0.02), rn(c, dtype=f32, mean=1.0, std=0.1), rn(c, dtype=f32, std=0.1)),
        s=torch.full((rows,), 1.25, device=dev),
        attn=(rn(3 * c, c, std=c ** -0.5), rn(3 * c, std=0.02), rn(c, c, std=c ** -0.5),
              rn(stage.n_type_windows, heads, 144, 144, dtype=f32), mask),
        statics=(stage.window, heads, (c // heads) ** -0.5))


def k3_call(inp: dict) -> Callable[[], object]:
    wqkv, bqkv, wproj, bias, mask = inp["attn"]
    return lambda: fba.fused_block_attention_bwd(inp["x"], wqkv, bqkv, wproj, bias, mask,
                                                 inp["gy"], *inp["statics"])


def backward_split(stage, c: int, heads: int, dev, shifted: bool = False) -> dict:
    """K7's and K3's kernels at one stage shape, and the torch.mm yardstick of
    their products."""
    inp = stage_inputs(stage, c, heads, shifted, dev, seed=45)
    x2, g2, wide = inp["x"].reshape(-1, c), inp["gy"].reshape(-1, c), inp["wide"]
    f32 = torch.float32
    with torch.no_grad():
        k7 = kernel_ms(lambda: fmlp.fused_mlp_postnorm_bwd(x2, g2, *inp["mlp"], inp["s"]))
        k3 = kernel_ms(k3_call(inp))
        dq = wide[:, :3 * c]
        mm = {"K7 dW2 = dy^T a": (g2.t(), wide), "K7 dW1 = dh^T x": (wide.t(), x2),
              "K3 dWqkv = dqkv^T x": (dq.t(), x2), "K3 dWproj = g^T acc": (g2.t(), x2)}
        yard = {k: cuda_times_ms(lambda: torch.mm(a, b, out_dtype=f32))
                for k, (a, b) in mm.items()}
        wqkv = inp["attn"][0]
        yard["K3 dx = dqkv Wqkv (bf16 out)"] = cuda_times_ms(lambda: torch.mm(dq, wqkv))
    return dict(rows=inp["rows"], c=c, shifted=shifted, k7_kernels=k7, k3_kernels=k3,
                matmul_ms=yard)


def cut_libraries(tree: str) -> Dict[str, str]:
    """Build block_attention.cu of ``tree`` once per phase cut (in parallel);
    phase -> shared library."""
    src_dir = os.path.join(tree, "pangu_tpu_torch", "csrc")
    with open(os.path.join(src_dir, "block_attention.cu")) as f:
        launch = f.read()
    cuts = [c for launched, c in PHASE_CUTS.items() if launched in launch]
    if not cuts:
        raise ValueError(f"{tree}: K3 launches none of {list(PHASE_CUTS)}")
    with open(os.path.join(src_dir, "attention_bwd.cuh")) as f:
        src = f.read()
    root = os.path.join(_build.build_dir(), "..", "cuts")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for k, (phase, edits) in enumerate(cuts[0].items(), start=1):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{tree}: the attention backward has no cut point for {phase!r}")
            text = text.replace(old, new)
        d = os.path.join(root, f"cut{k}")
        shutil.copytree(src_dir, d)
        with open(os.path.join(d, "attention_bwd.cuh"), "w") as f:
            f.write(f"#define CUT {k}\n" + text)
        lib = os.path.join(root, f"cut{k}.so")
        procs[phase] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, os.path.join(d, "block_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for phase, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the cut {phase!r}:\n{err}")
    return {phase: lib for phase, (lib, _) in procs.items()}


def attention_kernel_ms(fn: Callable[[], object], n: int = 3) -> float:
    """Device ms of the attention kernel of one K3 call: its launches' total
    over n calls under torch.profiler, over n."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and _short(e.name).startswith("attention_bwd")) / n / 1e3


def phase_cuts(libs: Dict[str, str], stage, c: int, heads: int, dev) -> dict:
    """The attention kernel's time whole and with each phase cut, at one
    stage (unshifted)."""
    inp = stage_inputs(stage, c, heads, False, dev, seed=45)
    call = k3_call(inp)
    res = {"whole": attention_kernel_ms(call)}
    load = _build.load_library
    try:
        for phase, path in libs.items():
            lib = ctypes.CDLL(path)
            _build.load_library = lambda source, lib=lib: lib
            res[phase] = attention_kernel_ms(call)
    finally:
        _build.load_library = load
    return res


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cuts", metavar="TREE", help="also time phase cuts of TREE's K3 kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA card")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    libs = cut_libraries(args.cuts) if args.cuts else {}
    g = compute_geometry(pangu_pretrain(24).model)
    for name, stage, c, heads in (("outer", g.outer, 192, 6), ("inner", g.inner, 384, 12)):
        for shifted in (False, True):
            res = backward_split(stage, c, heads, dev, shifted)
            if libs and not shifted:
                res["attention_phase_cuts_ms"] = phase_cuts(libs, stage, c, heads, dev)
            print(json.dumps({"stage": name, **res}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"device_kind": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
