"""Samples trained (forward, backward, Adam) in the window over its seconds."""


def read(rec):
    return rec.window.steps * rec.samples_per_step / rec.window.seconds
