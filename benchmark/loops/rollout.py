"""Rollout traffic: a closed loop of one client that runs forecasts of
``lead_steps`` steps back to back, each from the next of ``pool``
seeded initial states on the card, every step's output fed to the next step
and nothing copied to the host.

Correctness: before the window, ``checked_steps`` step indices are drawn
from the seed among the first ``check_forecasts`` forecasts (one first step,
one last step, the rest anywhere); the window copies each such step's input
and output aside on the card (slots allocated in set-up, which
``peak_gib.forecast`` leaves out). After the window the reference runs one
step from each input and the program's output is compared with it. A later
lead starts from the program's own state (the reference follows the program
step by step); the first steps start from the seeded states alone.

The model, its states, the reference and the gaps are the architecture
module's (``harness.architecture``); a state is a tuple of any length.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness, inputs, trace


def checked(traffic: dict, seed: int) -> list:
    """The step indices whose answers are compared."""
    rng = inputs.host_rng(seed, "sample")
    lead, forecasts = traffic["lead_steps"], traffic["check_forecasts"]
    picks = {rng.randrange(forecasts) * lead, rng.randrange(forecasts) * lead + lead - 1}
    while len(picks) < min(traffic["checked_steps"], lead * forecasts):
        picks.add(rng.randrange(lead * forecasts))
    return sorted(picks)


def run(ctx) -> harness.Record:
    cell, seed, device = ctx.cell, ctx.seed, ctx.device
    config, t = cell.config, cell.traffic
    arch = harness.architecture(config)
    harness.set_precision(config)
    _, model = arch.build_model(cell, seed, device)
    k = arch.constants(config, seed, device)
    pool = arch.states(config, k, seed, device, t["pool"], t["batch"])
    forecast = arch.forecast_step(model, arch.aux_constants(k))
    lead, n = t["lead_steps"], len(pool[0])
    slots = {i: tuple(torch.empty_like(x) for x in pool[0] + pool[0])
             for i in checked(t, seed)}
    state = [pool[0]]

    def step(i: int) -> None:
        f, j = divmod(i, lead)
        if j == 0:
            state[0] = pool[f % len(pool)]
        slot = slots.get(i)
        if slot is not None:
            for dst, x in zip(slot, state[0]):
                dst.copy_(x)
        state[0] = forecast(*state[0])
        if slot is not None:
            for dst, x in zip(slot[n:], state[0]):
                dst.copy_(x)

    for _ in range(t["warmup_steps"]):
        forecast(*pool[0])
    harness.sync(device)
    setup_s = time.perf_counter() - ctx.t0
    setup_peak = harness.peak_bytes(device, reset=True)
    window = harness.run_window(step, ctx.seconds, device)
    window_peak = harness.peak_bytes(device)
    profile, dispatch = None, None
    if ctx.trace:
        after = window.steps
        dispatch = harness.dispatch_ms(step, after, t["dispatch_steps"], device)
        profile = trace.profile_steps(step, after + t["dispatch_steps"], t["profiled_steps"],
                                      lambda: harness.sync(device), ctx.counters)
    del model, forecast, state
    harness.release(device)

    params = arch.weights(config, seed, device)
    readings = []
    with torch.no_grad():
        for i, slot in slots.items():
            if i >= window.steps:
                continue
            out = arch.reference_step(params, config, slot[:n], k)
            readings.append(arch.forecast_gaps(slot[n:], out, k))
    rec = harness.Record(cell=cell, setup_s=setup_s, window=window,
                         samples_per_step=t["batch"],
                         flops_per_step=arch.forward_matmul_flops(config, t["batch"]),
                         window_peak_bytes=window_peak, setup_peak_bytes=setup_peak,
                         held_bytes=sum(x.nbytes for s in slots.values() for x in s),
                         peaks=ctx.peaks, profile=profile, dispatch_ms=dispatch)
    harness.judge(rec, readings)
    return rec
