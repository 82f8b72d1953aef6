"""The 95th percentile of the window's step latencies: each from the end of
the step before to its own end, on the card's stream (CUDA events), so a
stall counts to the step it delays."""

import statistics


def read(rec):
    ms = rec.window.step_ms
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
