"""The yardstick's arithmetic that no architecture owns: the peaks of a
card, and the least time a kernel call could take. A model's product FLOPs
per step are its architecture module's (``arch/<name>.py``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(device_name: str) -> Dict[str, float]:
    """The card's published peaks (FLOP/s by dtype, ``bytes_per_s``). A card
    that is not in ``peaks.json`` is an error: the run never guesses."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    if device_name not in table:
        raise KeyError(f"no peaks for {device_name!r} in {PEAKS_FILE}")
    return {k: float(v) for k, v in table[device_name].items() if not k.startswith("_")}


def bound_s(work: Tuple[float, float, float], pk: Dict[str, float]) -> float:
    """The least time of one call doing ``work`` = (bf16 product FLOP, f32
    elementwise FLOP, compulsory bytes): the larger of its operations over
    their peaks and its bytes over the memory rate."""
    mm, ew, nbytes = work
    return max(mm / pk["bfloat16"] + ew / pk["float32"], nbytes / pk["bytes_per_s"])
