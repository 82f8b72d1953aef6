"""Device ms per traced step of the kernels launched inside the optimizer's
``Optimizer.step`` span (Adam's update)."""

from benchmark import trace


def read(rec):
    prof = rec.profile
    if prof is None:
        return None
    us = trace.under_span_us(prof.events, "Optimizer.step")
    return None if not us else us * 1e-3 / prof.steps
