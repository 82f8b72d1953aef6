"""The card's idle share of the traced steps: 1 - (the union of its
kernels, copies and sets) / (the stretch's wall time), in %. A card that
waits inside a kernel counts as busy."""

from benchmark import trace


def read(rec):
    prof = rec.profile
    if prof is None or not trace.device_events(prof.events):
        return None
    return 100.0 * (1.0 - trace.busy_us(prof.events) * 1e-6 / prof.wall_s)
