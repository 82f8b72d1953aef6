"""The whole step's share of the cards' peak: the model's product FLOPs per
step (``work.py``, of the step's global batch) times the steps of the
window, over the window's seconds, over the cell's cards times the peak of
the configuration's compute dtype (``peaks.json``), in %."""


def read(rec):
    if rec.peaks is None:
        return None
    peak = rec.peaks[rec.model["compute_dtype"]] * rec.cell.chips
    return 100.0 * rec.flops_per_step * rec.window.steps / rec.window.seconds / peak
