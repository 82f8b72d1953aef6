"""LR schedules (port of ``pangu_tpu/train/schedule.py``)."""

from __future__ import annotations

from collections import Counter
from typing import Callable, Sequence


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """Piecewise-constant decay at epoch milestones, as a function of the
    optimizer step count: from step ``m * steps_per_epoch`` on, the LR is
    multiplied by ``gamma`` once per occurrence of ``m`` in ``milestones``
    (torch MultiStepLR's Counter semantics, optax's piecewise-constant
    schedule)."""
    counts = Counter(int(m) for m in milestones)
    bounds = sorted((m * max(1, steps_per_epoch), gamma ** c) for m, c in counts.items())

    def schedule(step: int) -> float:
        lr = base_lr
        for bound, factor in bounds:
            if step >= bound:
                lr *= factor
        return lr

    return schedule
