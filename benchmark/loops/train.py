"""Train traffic: finetune steps (forward, backward, Adam) back to back, each
on the next (input, 24 h target) pair of ``pool`` seeded pairs on the card,
drop paths drawn from one seeded generator on the card.

Correctness: set-up builds the one train step with its model and Adam state
and runs its first ``first_steps`` steps through the window's own call, on
pairs 0, 1, 2, ...: their losses, the first gradient as Adam took it (its
first moment over 1 - beta1) and each parameter's change over those steps
are kept, and the same step goes on into the window. After the window the
reference trains from the same weights on the same pairs with the same
drop-path draws for as many steps, and ``compare.train_gaps`` compares the
program's numbers with it.
"""

from __future__ import annotations

import time
from typing import List

import torch

from benchmark import compare, harness, inputs, program, trace, work
from benchmark.reference import pangu as reference


def pairs(m: dict, k, seed: int, device, traffic: dict) -> List[tuple]:
    """(input upper, input surface, target upper, target surface) x pool."""
    s = inputs.states(m, k, seed, device, 2 * traffic["pool"], traffic["batch"])
    return [s[2 * j] + s[2 * j + 1] for j in range(traffic["pool"])]


def reference_steps(config: dict, k, steps: List[tuple], seed: int, device,
                    precision: str = "f32") -> dict:
    """The reference's losses, first gradient norms (decay added, as Adam
    takes it) and change norms over ``steps`` (one pair each): from the
    seed's weights, each step's drop paths drawn as the program draws them."""
    m, tr = config["model"], config["train"]
    params = inputs.weights(m, seed, device)
    for p in params.values():
        p.requires_grad_(True)
    adam = reference.Adam(params, tr["lr"], tr["weight_decay"])
    gen = inputs.generator(seed, "drop_path", device)
    losses, grad = [], None
    for u, s, tu, ts in steps:
        scales = reference.drop_path_scales(m, u.shape[0], gen, device)
        ou, os_ = reference.forward(params, m, u, s, k, precision, scales, remat=m["remat"])
        loss = reference.loss(ou, os_, tu, ts, k)
        g = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        del ou, os_, loss
        taken = adam.step(dict(zip(params, g)))
        if grad is None:
            grad = compare.leaf_norms(taken)
        del g, taken
    start = inputs.weights(m, seed, device)
    update = {n: float((params[n].detach() - start[n]).double().norm()) for n in params}
    return {"losses": losses, "grad": grad, "update": update}


def run(ctx) -> harness.Record:
    cell, seed, device = ctx.cell, ctx.seed, ctx.device
    m, t = cell.config["model"], cell.traffic
    harness.set_precision(cell.config)
    cfg, model = program.build_model(cell, seed, device)
    k = inputs.constants(m, cell.config["train"], seed, device)
    aux = program.aux_constants(k)
    pool = pairs(m, k, seed, device, t)
    batches = [program.batch(*p) for p in pool]
    gen = inputs.generator(seed, "drop_path", device)
    losses = []
    train, optimizer = program.train_step(model, cfg, t["steps_per_epoch"])

    def step(i: int) -> None:
        losses.append(train(batches[i % len(batches)], aux, gen))

    first = t["first_steps"]
    beta1 = optimizer.param_groups[0]["betas"][0]
    for i in range(first):
        step(i)
        if i == 0:
            grad = {n: float(v.double().norm()) / (1 - beta1)
                    for n, v in program.first_moments(optimizer, model).items()}
    start = inputs.weights(m, seed, device)
    update = {n: float((p.detach() - start[n]).double().norm())
              for n, p in model.named_parameters()}
    del start
    prog = {"losses": [float(x) for x in losses[:first]], "grad": grad, "update": update}
    harness.sync(device)
    setup_s = time.perf_counter() - ctx.t0
    setup_peak = harness.peak_bytes(device, reset=True)
    window = harness.run_window(lambda j: step(first + j), ctx.seconds, device)
    window_peak = harness.peak_bytes(device)
    profile = None
    if ctx.trace:
        profile = trace.profile_steps(step, first + window.steps, t["profiled_steps"],
                                      lambda: harness.sync(device), ctx.counters)
    del model, train, optimizer, batches, losses, pool
    harness.release(device)
    # the pairs made again from the seed, so that nothing the program did to
    # its inputs reaches the reference
    ref = reference_steps(cell.config, k, pairs(m, k, seed, device, t)[:first], seed, device)
    rec = harness.Record(cell=cell, setup_s=setup_s, window=window,
                         samples_per_step=t["batch"],
                         flops_per_step=work.train_matmul_flops(m, t["batch"]),
                         window_peak_bytes=window_peak, setup_peak_bytes=setup_peak,
                         peaks=ctx.peaks, profile=profile)
    harness.judge(rec, [compare.train_gaps(prog, ref)])
    return rec
