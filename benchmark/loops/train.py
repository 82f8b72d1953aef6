"""Train traffic: finetune steps (forward, backward, Adam) back to back, each
on the next (input, target) pair of ``pool`` seeded pairs on the card,
drop paths drawn from one seeded generator on the card.

Correctness: set-up builds the one train step with its model and Adam state
and runs its first ``first_steps`` steps through the window's own call, on
pairs 0, 1, 2, ...: their losses, the first gradient as Adam took it (its
first moment over 1 - beta1) and each parameter's change over those steps
are kept, and the same step goes on into the window. After the window the
reference trains from the same weights on the same pairs with the same
drop-path draws for as many steps, and ``compare.train_gaps`` compares the
program's numbers with it.

The model, its pairs, its train step and the reference are the
architecture module's (``harness.architecture``), which has to keep the
contract's training part: one without it cannot run a train cell, and the
harness names what it lacks.
"""

from __future__ import annotations

import time

import torch

from benchmark import arch as contract
from benchmark import compare, harness, inputs, trace


def run(ctx) -> harness.Record:
    cell, seed, device = ctx.cell, ctx.seed, ctx.device
    config, t = cell.config, cell.traffic
    arch = harness.architecture(config, contract.TRAINING)
    harness.set_precision(config)
    cfg, model = arch.build_model(cell, seed, device)
    k = arch.constants(config, seed, device)
    aux = arch.aux_constants(k)
    pool = arch.pairs(config, k, seed, device, t)
    batches = [arch.batch(*p) for p in pool]
    gen = inputs.generator(seed, "drop_path", device)
    losses = []
    train, optimizer = arch.train_step(model, cfg, t["steps_per_epoch"])

    def step(i: int) -> None:
        losses.append(train(batches[i % len(batches)], aux, gen))

    first = t["first_steps"]
    beta1 = optimizer.param_groups[0]["betas"][0]
    for i in range(first):
        step(i)
        if i == 0:
            grad = {n: float(v.double().norm()) / (1 - beta1)
                    for n, v in arch.first_moments(optimizer, model).items()}
    start = arch.weights(config, seed, device)
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
    ref = arch.reference_steps(config, k, arch.pairs(config, k, seed, device, t)[:first], seed,
                               device)
    rec = harness.Record(cell=cell, setup_s=setup_s, window=window,
                         samples_per_step=t["batch"],
                         flops_per_step=arch.train_matmul_flops(config, t["batch"]),
                         window_peak_bytes=window_peak, setup_peak_bytes=setup_peak,
                         peaks=ctx.peaks, profile=profile)
    harness.judge(rec, [compare.train_gaps(prog, ref)])
    return rec
