"""Where the costliest attention kernels, K7 and K12 spend their time, on one
CUDA card.

    python -m pangu_tpu_torch.scripts.profile_bwd_split [--cuts TREE [--only TEXT]] [--no-split]
        [--k12]

For the MLP-tail backward K7 (``fused_mlp_postnorm_bwd``) and the attention
backward K3 (``fused_block_attention_bwd``) at the flagship outer and inner
stage shapes, unshifted and shifted, with seeded inputs: the device time of
every kernel that one call launches, in launch order (torch.profiler, the
mean over 3 calls), and beside the weight-grad products one ``torch.mm`` of
the same product (bf16 in, f32 out; the dx product bf16 out), a yardstick
the port never calls.

``--k12``: also the training-block backward K12 (``fused_earth_block_train_bwd``,
per-sample scales s1 = 1.25, s2 = 0.8) by kernel at every stage and shift:
each launch in order with its device ms, and the sums by kernel name. Run as
a file (``PYTHONPATH=TREE python pangu_tpu_torch/scripts/profile_bwd_split.py
--k12 --no-split``) it times the kernels of checkout TREE.

``--cuts TREE``: also time kernels of TREE whole and with their phases cut
out, one phase at a time and all at once (``all``), at every stage and shift:
K3's attention kernel through K3, the window-attention kernel through K1,
K12's row pass through K12, and S2's ``local_accum_kernel`` through
``bench_attn_bwd_ab.local_accum`` (outer stage, unshifted only).
The cuts (``PHASE_CUTS``) are text edits of the kernel as TREE has it, found
by a text of its schedule; each is a throwaway build of
``TREE/pangu_tpu_torch/csrc`` under ``build/variants/`` (the outputs are
wrong on purpose; a phase's cost is the whole kernel's time less the cut
one's), loaded in place of this tree's library (the C interface is the
same). ``--only`` keeps the kernels whose name holds TEXT; a tree with none
is refused.

Prints one JSON line per stage and shift, then ``{"device_kind": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
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
from pangu_tpu_torch.ops import fused_block_train as fbt
from pangu_tpu_torch.ops import fused_mlp as fmlp
from pangu_tpu_torch.scripts.ab_common import cuda_times_ms


def _guard(text: str, k: int) -> Tuple[str, str]:
    """The edit that skips the statement starting at ``text`` under cut k."""
    body = text.lstrip(" ")
    return text, text[:len(text) - len(body)] + f"if (!CUT_{k}) " + body


def _bound(text: str, old: str, k: int) -> Tuple[str, str]:
    """The edit that makes the loop ``for (... < old; ...)`` starting at
    ``text`` run no iteration under cut k."""
    return text, text.replace(old, f"(CUT_{k} ? 0 : {old})", 1)


#: kernel -> how to find it in a tree (a file of csrc/ and a text in it), the
#: header its phase cuts edit, the source built with them, the wrapper call
#: that times it (``k1``: K1; ``k3``: K3; ``k12``: K12; ``s2``: S2's
#: ``local_accum``), the prefix of its kernel name, the one (stage, shifted)
#: it runs at where it does not take them all (``at``), and its phases:
#: phase -> edits (text of the kernel, its replacement, which cuts the phase
#: under CUT_k, k the phase's place, from 1). ``all`` cuts every phase at once.
PHASE_CUTS: Dict[str, dict] = {
    # K3, the register-resident schedule, mma.sync
    "attention_bwd_regs_kernel": dict(
        find=("block_attention.cu", "attention_bwd_regs_kernel<true><<<"),
        header="attention_bwd.cuh", source="block_attention.cu", call="k3",
        prefix="attention_bwd", phases={
            "recompute q|k|v and dO": [
                _guard("      pipelined(\n"
                       "          C / K3_KC, stage0, stage0 + K3_STAGE_ELEMS,", 1)],
            "S = q k^T": [_bound("        for (int nb = 0; nb < T / 16; ++nb) {\n"
                                 "#pragma unroll\n"
                                 "          for (int e = 0; e < 4; ++e) s[2 * nb][e]",
                                 "T / 16", 2)],
            "softmax (bias, mask, P rows)": [_bound(
                "      for (int h = 0; h < 2; ++h) {  // rows gq and gq + 8", "2", 3)],
            "O = P v, the acc store and D": [
                _bound("        for (int kb = 0; kb < T / 16; ++kb) {\n"
                       "          const uint32_t pa[4]", "T / 16", 4),
                _bound("        for (int h = 0; h < 2; ++h) {\n"
                       "          const int r = q0 + gq + 8 * h;", "2", 4)],
            "dP, dS, dbias and dq": [_bound(
                "        for (int nb = 0; nb < T / 16; ++nb) {\n          float dp[2][4] = {};",
                "T / 16", 5)],
            "dk and dv": [_bound("      for (int qb = 0; qb < T / 16; ++qb) {", "T / 16", 6)],
            "the dqkv slab stores": [_bound(
                "      for (int h = 0; h < 2; ++h) {\n        bf16* row = dqkv", "2", 7)],
        }),
    # the window-attention forward of K1 and K2, mma.sync with scores and
    # probabilities in registers
    "window_attention_kernel (mma.sync)": dict(
        find=("window_attention.cuh", "P from the score registers"),
        header="window_attention.cuh", source="fused_earth_block.cu", call="k1",
        prefix="window_attention", phases={
            "S = q k^T": [_bound("      for (int kk = 0; kk < 2; ++kk) {\n"
                                 "        uint32_t kb[4];", "2", 1)],
            "scale, bias and mask": [_bound(
                "      for (int j = 2 * nb; j < 2 * nb + 2; ++j)", "2 * nb + 2", 2)],
            "softmax": [_bound("  for (int h = 0; h < 2; ++h) {\n    float m = -INFINITY;",
                               "2", 3)],
            "P v": [_bound("  for (int kb = 0; kb < T / 16; ++kb) {\n    const uint32_t pa[4]",
                           "T / 16", 4)],
        }),
    # S2's local_accum: K3's attention kernel with the weight grads summed on
    # chip per window and dbias in device memory (outer stage, mask-free)
    "local_accum_kernel": dict(
        find=("bench_attn_bwd_ab.cu", "local_accum_kernel<<<"),
        header="bench_attn_bwd_ab.cu", source="bench_attn_bwd_ab.cu", call="s2",
        prefix="local_accum_kernel", at=("outer", False), phases={
            "the weight sums (x, g and acc again, their products)": [
                _guard("      for (int v = threadIdx.x; v < T * (D / 8); v += BWD_THREADS) {\n"
                       "        const int t = v / (D / 8)", 1),
                _guard("      load_chunk(0);\n", 1), _guard("      load_chunk(1);\n", 1),
                _bound("      for (int i = 0; i < LC / LKC; ++i) {", "LC / LKC", 1)],
            "the dbias tile's read and write in device memory": [
                _guard("          if (!first)\n#pragma unroll", 2),
                _guard("            __stcg(reinterpret_cast<float2*>(dbias_rows + 8 * j), lo);", 2),
                _guard("            __stcg(reinterpret_cast<float2*>(dbias_rows + 8 * T + 8 * j), "
                       "hi2);", 2)],
        }),
    # K12's row pass: the row kernel with PROJ and BWD (the projection, LN1, a
    # and x1 written, the MLP, the LN2 backward), through K12
    "mlp_tail_kernel (K12 row pass)": dict(
        find=("fused_block_train.cu", "launch_mlp_tail<C, true, true, true, true>"),
        header="mlp_wg.cuh", source="fused_block_train.cu", call="k12",
        prefix="mlp_tail_kernel", phases={
            "the a and x1 stores": [_guard(
                "            if (live) {\n"
                "              *reinterpret_cast<__nv_bfloat162*>(a_out", 1)],
            "dy and the column sums": [_bound(
                "        for (int g = 0; g < NG; ++g) {\n          const int c = c0 + 8 * g;\n"
                "          const float2 gm = *reinterpret_cast<const float2*>(ln2_s + c);\n"
                "          float p[3][2] = {};", "NG", 2)],
        }),
}


class NoKernelEvents(RuntimeError):
    """The profiler saw no kernel event of a call, or a count that the calls
    do not divide: its per-kernel times cannot be formed."""


def _kernel_events(fn: Callable[[], object], n: int) -> list:
    """The kernel events of n calls of ``fn`` (after one call outside the
    profile) under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_ms(fn: Callable[[], object], n: int = 3) -> List[Tuple[str, float]]:
    """(name, device ms) of each kernel that one call of ``fn`` launches, in
    launch order: the mean over n calls under torch.profiler. Raises
    NoKernelEvents when the profiler recorded no kernel, or a number of them
    that n does not divide."""
    ev = sorted(_kernel_events(fn, n), key=lambda e: e.time_range.start)
    if not ev or len(ev) % n:
        raise NoKernelEvents(f"the profiler recorded {len(ev)} kernel events over {n} calls")
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


def s2_call(inp: dict) -> Callable[[], object]:
    """S2's ``local_accum`` on ``stage_inputs`` (the outer stage, unshifted)."""
    from pangu_tpu_torch.scripts import bench_attn_bwd_ab

    wqkv, bqkv, wproj, bias, _ = inp["attn"]
    return lambda: bench_attn_bwd_ab.local_accum(inp["x"], inp["gy"], wqkv, bqkv, wproj, bias)


def k12_call(inp: dict) -> Callable[[], object]:
    """K12 on ``stage_inputs``: the MLP's LayerNorm parameters serve both
    LayerNorms, bproj is bqkv's first C entries, s1 = 1.25 and s2 = 0.8."""
    wqkv, bqkv, wproj, bias, mask = inp["attn"]
    w1, b1, w2, b2, ln_s, ln_b = inp["mlp"]
    x = inp["x"]
    s1 = torch.full((x.shape[0],), 1.25, device=x.device)
    s2 = torch.full((x.shape[0],), 0.8, device=x.device)
    args = (x, wqkv, bqkv, wproj, bqkv[:x.shape[-1]].contiguous(), bias, mask, ln_s, ln_b,
            w1, b1, w2, b2, ln_s, ln_b, s1, s2, inp["gy"], *inp["statics"])
    return lambda: fbt.fused_earth_block_train_bwd(*args)


def block_bwd_split(stage, c: int, heads: int, dev, shifted: bool = False) -> dict:
    """K12's launches at one stage shape, in order, and their sums by kernel
    name (device ms, the mean over 3 calls)."""
    inp = stage_inputs(stage, c, heads, shifted, dev, seed=45)
    with torch.no_grad():
        launches = kernel_ms(k12_call(inp))
    by_name: Dict[str, list] = {}
    for name, ms in launches:
        entry = by_name.setdefault(name.split("<")[0], [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    return dict(k12_kernels=launches, k12_by_kernel=by_name,
                k12_ms=sum(ms for _, ms in launches))


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


def build_variant(tree: str, source: str, name: str, edits=(), header: str = "",
                  defines=()) -> Tuple[str, subprocess.Popen]:
    """Start nvcc on ``TREE/pangu_tpu_torch/csrc/<source>`` as a throwaway
    variant under ``build/variants/<name>``: ``header`` with text ``edits``
    applied and ``defines`` (``NAME=VALUE``) prepended to it. Returns the
    library's path and the nvcc process."""
    src_dir = os.path.join(tree, "pangu_tpu_torch", "csrc")
    d = os.path.join(_build.build_dir(), "..", "variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    if header:
        with open(os.path.join(d, header)) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{tree}: {header} has no single cut point {old[:60]!r}")
            text = text.replace(old, new)
        with open(os.path.join(d, header), "w") as f:
            f.write("".join(f"#define {v.replace('=', ' ', 1)}\n" for v in defines) + text)
    lib = d + ".so"
    return lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                                  os.path.join(d, source)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_built(procs: Dict[str, Tuple[str, subprocess.Popen]]) -> Dict[str, str]:
    """Wait for build_variant's processes; name -> library (ptxas's report
    beside it, ``.ptxas.txt``). Raises on a failed build."""
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{err}")
        with open(lib + ".ptxas.txt", "w") as f:
            f.write(err)
    return {name: lib for name, (lib, _) in procs.items()}


def cut_kernels(tree: str, only: str = "") -> Dict[str, dict]:
    """The entries of PHASE_CUTS found in ``tree`` (those whose name holds
    ``only``); a tree with none is refused."""
    src_dir = os.path.join(tree, "pangu_tpu_torch", "csrc")
    found = {}
    for kernel, spec in PHASE_CUTS.items():
        path = os.path.join(src_dir, spec["find"][0])
        if not os.path.exists(path):
            continue
        with open(path) as f:
            if spec["find"][1] in f.read() and only in kernel:
                found[kernel] = spec
    if not found:
        raise ValueError(f"{tree}: no kernel of {list(PHASE_CUTS)} (matching {only!r})")
    return found


def cut_libraries(tree: str, only: str = "") -> Dict[str, Dict[str, str]]:
    """Build, all at once, each kernel of ``tree`` found by ``cut_kernels``
    once whole, once per phase cut and once with every phase cut (``all``);
    kernel -> phase -> shared library."""
    procs, owner = {}, {}
    for kernel, spec in cut_kernels(tree, only).items():
        phases = list(spec["phases"])
        builds = {"whole": set(), **{p: {k} for k, p in enumerate(phases, start=1)},
                  "all": set(range(1, len(phases) + 1))}
        edits = [e for p in phases for e in spec["phases"][p]]
        for label, cut in builds.items():
            name = f"{spec['prefix']}-{len(owner)}"
            owner[name] = (kernel, label)
            procs[name] = build_variant(
                tree, spec["source"], name, edits, spec["header"],
                [f"CUT_{k}={int(k in cut)}" for k in range(1, len(phases) + 1)])
    libs = {}
    for name, lib in wait_built(procs).items():
        kernel, label = owner[name]
        libs.setdefault(kernel, {})[label] = lib
    return libs


def named_kernels_ms(fn: Callable[[], object], prefix: str, n: int = 3) -> float:
    """Device ms of the kernels of one call of ``fn`` whose names start with
    ``prefix``: their launches' total over n calls under torch.profiler, over
    n. Raises NoKernelEvents when the profiler recorded none of them, or a
    number that n does not divide (a launch it lost)."""
    ev = [e for e in _kernel_events(fn, n) if _short(e.name).startswith(prefix)]
    if not ev or len(ev) % n:
        raise NoKernelEvents(f"the profiler recorded {len(ev)} {prefix} kernel events over "
                             f"{n} calls")
    return sum(e.time_range.elapsed_us() for e in ev) / n / 1e3


def k1_call(inp: dict) -> Callable[[], object]:
    wqkv, bqkv, wproj, bias, mask = inp["attn"]
    w1, b1, w2, b2, ln_s, ln_b = inp["mlp"]
    args = (inp["x"], wqkv, bqkv, wproj, bqkv[:inp["x"].shape[-1]].contiguous(), bias, mask,
            ln_s, ln_b, w1, b1, w2, b2, ln_s, ln_b, *inp["statics"])
    return lambda: fba.fused_earth_block(*args)


@contextlib.contextmanager
def with_library(source: str, path: str):
    """Inside it, ``_build.load_library(source)`` returns the library at
    ``path``."""
    load = _build.load_library
    lib = ctypes.CDLL(path)
    _build.load_library = lambda s: lib if s == source else load(s)
    try:
        yield
    finally:
        _build.load_library = load


def phase_cuts(kernel: str, libs: Dict[str, str], stage, c: int, heads: int, dev,
               shifted: bool) -> dict:
    """Device ms of ``kernel`` (a PHASE_CUTS entry) whole and with each phase
    cut, at one stage, shifted or not."""
    spec = PHASE_CUTS[kernel]
    inp = stage_inputs(stage, c, heads, shifted, dev, seed=45)
    call = {"k1": k1_call, "k3": k3_call, "k12": k12_call, "s2": s2_call}[spec["call"]](inp)
    res = {}
    for phase, path in libs.items():
        with with_library(spec["source"], path):
            res[phase] = named_kernels_ms(call, spec["prefix"])
    return res


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cuts", metavar="TREE", help="also time phase cuts of TREE's kernels")
    ap.add_argument("--only", default="", metavar="TEXT",
                    help="cut only the kernels of PHASE_CUTS whose name holds TEXT")
    ap.add_argument("--no-split", action="store_true",
                    help="skip the kernel split of K7 and K3 (with --cuts: only the cuts)")
    ap.add_argument("--k12", action="store_true", help="also split K12 into its launches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA card")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    libs = cut_libraries(args.cuts, args.only) if args.cuts else {}
    g = compute_geometry(pangu_pretrain(24).model)
    for name, stage, c, heads in (("outer", g.outer, 192, 6), ("inner", g.inner, 384, 12)):
        for shifted in (False, True):
            res = {} if args.no_split else backward_split(stage, c, heads, dev, shifted)
            if args.k12:
                res.update(block_bwd_split(stage, c, heads, dev, shifted))
            for kernel, kl in libs.items():
                if PHASE_CUTS[kernel].get("at", (name, shifted)) != (name, shifted):
                    continue
                res.setdefault("phase_cuts_ms", {})[kernel] = phase_cuts(
                    kernel, kl, stage, c, heads, dev, shifted)
            print(json.dumps({"stage": name, "shifted": shifted, **res}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"device_kind": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
