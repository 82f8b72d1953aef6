"""The streams that the benchmark draws from ``--seed``, for the program and
the reference alike: each architecture module draws its weights, constants
and states from them (``arch/<name>.py``).

Everything is drawn on the run's device by a ``torch.Generator`` of that
device, in a few large calls, so one seed gives the same tensors to both
sides and to a second run on the same kind of device. Each kind of input has
a stream of its own, so adding one never moves another.
"""

from __future__ import annotations

import random

import torch

STREAMS = {"weights": 1, "constants": 2, "states": 3, "drop_path": 4, "sample": 5}
_MIX = 0x9E3779B97F4A7C15


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of ``stream`` for the run's ``seed`` (any whole number)."""
    return (int(seed) * _MIX + STREAMS[stream] * 0xBF58476D1CE4E5B9) % 2**63


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def host_rng(seed: int, stream: str) -> random.Random:
    return random.Random(stream_seed(seed, stream))

