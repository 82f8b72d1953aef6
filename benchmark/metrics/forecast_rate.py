"""Forecast steps completed in the window, one per member, over the window's
seconds."""


def read(rec):
    return rec.window.steps * rec.samples_per_step / rec.window.seconds
