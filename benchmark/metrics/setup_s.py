"""Seconds from the start of the process to the first timed step: imports,
the kernels' build (or load), weights, constants and inputs, the warm-up."""


def read(rec):
    return rec.setup_s
