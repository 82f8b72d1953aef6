"""What the on-card tests (tests/test_torch_gpu.py) and the rank workers of
the data-parallel, spatial and pipeline tests share when they run on the
card: the flagship bf16 config on the kernel route, a seeded batch, a digest
of the parameters' bits, the kernels' launch counters, a train step's loss
and gradients against a reference step's, the block functions on a slab of
the token grid, and the spawning of a worker's ranks (the CPU tests use the
last two too). It imports nothing of jax or the JAX package.
"""

import json
import math
import os
import subprocess
import sys
import time

import torch

from pangu_tpu_torch.config import pangu_pretrain
from pangu_tpu_torch.ops import cosine_attention as fca
from pangu_tpu_torch.ops import fused_block_attention as fba
from pangu_tpu_torch.ops import fused_block_train as fbt
from pangu_tpu_torch.ops import fused_mlp as fmlp
from pangu_tpu_torch.train import Batch

#: a flagship train step's launches of the blocks' kernels with remat and the config's
#: flags, which keep the attention and MLP outputs: the checkpoint recompute runs only the
#: first residual (K4)
BLOCK_TRAIN_LAUNCHES = {"fused_block_attention": 16, "fused_block_attention_bwd": 16,
                        "fused_residual_postnorm": 32, "fused_residual_postnorm_bwd": 16,
                        "fused_mlp_postnorm": 16, "fused_mlp_postnorm_bwd": 16}
#: the Dense products of the layers' outsides a sample (bf16 on the card: the Dense
#: kernel), by the model op that runs them: the patch embedding's surface and upper
#: projections, the downsampling's linear, the upsampling's two, the recovery's two
OUTER_DENSE = {"patch_embed": 2, "downsample": 1, "upsample": 2, "patch_recovery": 2}
#: a flagship step's Dense launches outside the blocks: forward, and in training backward
FORECAST_DENSE = {"dense": sum(OUTER_DENSE.values())}
TRAIN_DENSE = {**FORECAST_DENSE, "dense_bwd": sum(OUTER_DENSE.values())}
#: a flagship train step's launches: the blocks' kernels and the outsides' products
TRAIN_LAUNCHES = {**BLOCK_TRAIN_LAUNCHES, **TRAIN_DENSE}
#: a flagship forecast step's launches: K1 a block and the outsides' products
FORECAST_LAUNCHES = {"fused_earth_block": 16, **FORECAST_DENSE}
#: a plain bf16 flagship train step's launches (no block kernel): the Dense kernel runs
#: the outsides' 7 products and each block's 4 (qkv, projection, the MLP's two) in the
#: forward and again in the checkpoint recompute, and the backward of all 71
PLAIN_TRAIN_LAUNCHES = {"dense": 7 + 2 * 4 * 16, "dense_bwd": 7 + 4 * 16}
#: a kernel-route train step against the plain bf16 step from the same weights, batch
#: and drop-path draws: the loss's relative deviation, the gradient's global relative
#: L2, and the worst relative L2 of one earth-specific bias and of one other parameter
TRAIN_BOUNDS = dict(loss_rel_dev=0.01, grad_rel_l2=0.01, worst_bias_rel_l2=0.1,
                    worst_other_rel_l2=0.02)
#: the gradients of K3, the training attention's backward
ATTN_GRADS = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
#: the odd constant of ``digest``'s multipliers (2**64 / golden ratio, as int64)
_DIGEST_MULT = 0x9E3779B97F4A7C15 - 2**64


def flagship(**kw):
    """The 24 h model's config in bf16 on the kernel route."""
    return pangu_pretrain(24, compute_dtype="bfloat16", matmul_precision="default",
                          use_pallas_attention=True, **kw)


def seeded_batch(aux, m, dev, rows: int = 1) -> Batch:
    """Seeded physical-unit inputs and targets (the inputs plus noise) of
    ``rows`` samples, made on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = [aux.upper_mean + aux.upper_std * torch.randn(
        (rows, m.upper_vars, m.levels, m.lat, m.lon), generator=gen, device=dev),
        aux.surface_mean + aux.surface_std * torch.randn(
        (rows, m.surface_vars, m.lat, m.lon), generator=gen, device=dev)]
    targets = [x + 0.5 * std * torch.randn(x.shape, generator=gen, device=dev)
               for x, std in zip(inputs, (aux.upper_std, aux.surface_std))]
    return Batch(*inputs, *targets)


def launches() -> dict:
    """Every kernel's launches so far in this process."""
    from pangu_tpu_torch.scripts.bench_train_ab import launch_counts

    return {"fused_earth_block": fba.LAUNCHES, **launch_counts(),
            "fused_mlp_block": fmlp.BLOCK_LAUNCHES,
            "fused_block_attention_ln": fba.ATTN_LN_LAUNCHES,
            "cosine_window_attention": fca.LAUNCHES, "dense": fba.DENSE_LAUNCHES,
            "dense_bwd": fba.DENSE_BWD_LAUNCHES}


def stage_launches(ops, blocks: int, micro: int) -> dict:
    """What a pipeline stage of the model ops ``ops`` holding ``blocks``
    blocks launches in a flagship train step of ``micro`` microbatches on the
    default route."""
    want = {k: v // 16 * blocks * micro for k, v in BLOCK_TRAIN_LAUNCHES.items()} if blocks else {}
    dense = sum(OUTER_DENSE.get(op, 0) for op in ops) * micro
    return {**want, "dense": dense, "dense_bwd": dense} if dense else want


def launched(before: dict) -> dict:
    """The launches since ``before`` (a ``launches()``), kernels that ran only."""
    return {k: v - before[k] for k, v in launches().items() if v != before[k]}


def digest(model) -> list:
    """A digest of every parameter's bits, in name order, computed where the
    parameters lie: each tensor's 32-bit words times odd per-position
    multipliers, summed modulo 2**64 (one flipped bit changes it)."""
    out = []
    for _, p in model.named_parameters():
        words = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        mult = torch.arange(words.numel(), device=words.device, dtype=torch.int64)
        out.append(int((words * (mult * _DIGEST_MULT + 1)).sum()))
    return out


def train_deviation(loss: float, grads: dict, ref_loss: float, ref_grads: dict) -> dict:
    """One step's loss and gradients against a reference step's, in the
    terms of ``TRAIN_BOUNDS``."""
    d2 = {k: (grads[k].float() - ref_grads[k].float()).pow(2).sum().item() for k in ref_grads}
    n2 = {k: g.float().pow(2).sum().item() for k, g in ref_grads.items()}
    leaf = {k: math.sqrt(d2[k] / max(n2[k], 1e-30)) for k in d2}
    return dict(loss_rel_dev=abs(loss - ref_loss) / abs(ref_loss),
                grad_rel_l2=math.sqrt(sum(d2.values()) / sum(n2.values())),
                worst_bias_rel_l2=max(v for k, v in leaf.items()
                                      if k.endswith("earth_specific_bias")),
                worst_other_rel_l2=max(v for k, v in leaf.items()
                                       if not k.endswith("earth_specific_bias")))


def within_train_bounds(d: dict) -> bool:
    return all(d[k] < bound for k, bound in TRAIN_BOUNDS.items())


def place_types(t: torch.Tensor, slab, like: torch.Tensor) -> torch.Tensor:
    """A slab's per-window-type gradient (dbias) put at its types of a zero
    tensor shaped as the whole table ``like``."""
    nz = slab.stage.z // slab.stage.window[0]
    a, b = slab.lat_windows
    out = torch.zeros_like(like).reshape(nz, like.shape[0] // nz, *like.shape[1:])
    out[:, a:b] = t.reshape(nz, b - a, *t.shape[1:])
    return out.reshape(like.shape)


def block_calls(route: str, args, statics, gy, slab=None) -> dict:
    """The forward and the backward of ``route`` ("attention": K2/K3 of the
    default route; "block": K11/K12, with K1 beside its forward) on
    ``slab`` of the grid ``args[0]`` (the whole grid when None), the earth
    bias and shift mask cut to it: {name: (outputs, gradients, gradient
    names)}. The branch scales of K11/K12 are 1.25 and 0.8."""
    x, wqkv, bqkv, wproj, bproj, bias, mask = args[:7]
    if slab is not None:
        (r0, r1), (c0, c1) = slab.rows, slab.cols
        x, gy = (t[:, :, r0:r1, c0:c1].contiguous() for t in (x, gy))
        bias, mask = slab.cut_types(bias), None if mask is None else slab.cut_types(mask)
    a = (x, *args[1:5], bias, mask, *args[7:])
    if route == "attention":
        y = fba.fused_block_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, None, None,
                                      *statics)
        grads = fba.fused_block_attention_bwd(x, wqkv, bqkv, wproj, bias, mask, gy, *statics)
        return {"K2/K3": ((y,), grads, ATTN_GRADS)}
    s1, s2 = torch.full((1,), 1.25, device=x.device), torch.full((1,), 0.8, device=x.device)
    return {"K1": ((fba.fused_earth_block(*a, *statics),), (), ()),
            "K11/K12": ((fbt.fused_earth_block_train(*a, s1, s2, *statics),),
                        fbt.fused_earth_block_train_bwd(*a, s1, s2, gy, *statics),
                        fbt.GRAD_NAMES)}


def spawn(world: int, spec: dict, out: str, worker: str, timeout_s: float) -> list:
    """Run ``world`` ranks of the rank worker script ``worker``, each given
    ``spec`` with its rank, ``out`` and a ``file://`` store under ``out``;
    return each rank's saved results. The ranks get ``timeout_s`` together;
    on a failure or a timeout every rank is killed and the test fails with
    the failed rank's output."""
    import pytest

    os.makedirs(out, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(os.path.join(out, f"rank{r}.log"), "w"))
            s = dict(spec, world=world, rank=r, out=out,
                     init="file://" + os.path.join(out, "store"))
            procs.append(subprocess.Popen([sys.executable, worker, json.dumps(s)],
                                          stdout=logs[r], stderr=subprocess.STDOUT, cwd=repo,
                                          env=env))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.monotonic() > deadline:
                r = bad[0] if bad else codes.index(None)
                with open(os.path.join(out, f"rank{r}.log")) as f:
                    text = f.read()[-3000:]
                pytest.fail(f"world {world}: rank {r} "
                            f"{'exited %s' % codes[r] if bad else 'timed out'}:\n{text}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]
