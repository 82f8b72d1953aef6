"""The yardstick's arithmetic: the model's product FLOPs per step, the
peaks of a card, and the least time a kernel call could take.

``forward_matmul_flops`` is a copy of the program's analytic count
(``utils/flops.py``): 2 FLOP per multiply-add of every product of the
forward pass, blocks counted on the window-padded grid, elementwise work
not counted. A train step is 3 forwards (each product has two backward
products of its shape); a recompute under remat is not counted.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from benchmark.reference.pangu import Stage, grid, stage_of

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def forward_matmul_flops(m: dict, batch: int = 1) -> float:
    g = grid(m)
    c0, pz, ph, pw = m["dims"][0], *m["patch"]
    surf_tokens, upper_tokens = g.h * g.w, g.zu * g.h * g.w
    embed_u = (m["upper_vars"] + m["upper_const_channels"]) * pz * ph * pw
    embed_s = (m["surface_vars"] + m["surface_const_channels"]) * ph * pw
    total = 2.0 * (surf_tokens * embed_s * c0 + upper_tokens * embed_u * c0)
    for i, (depth, c) in enumerate(zip(m["depths"], m["dims"])):
        st = stage_of(m, i)
        tokens = st.z * st.hp * st.w
        windows = st.n_types * (st.w // st.window[2])
        attn = 2.0 * tokens * c * 3 * c + 2 * (2.0 * windows * st.tokens ** 2 * c) \
            + 2.0 * tokens * c * c
        mlp = 2.0 * (2.0 * tokens * c * m["mlp_ratio"] * c)
        total += depth * (attn + mlp)
    half = g.outer.z * g.h2 * (g.w // 2)
    total += 2.0 * half * 4 * m["dims"][0] * m["dims"][1]
    total += 2.0 * (half * m["dims"][2] * 4 * m["dims"][3]
                    + g.outer.z * g.h * g.w * m["dims"][3] ** 2)
    cin = m["dims"][0] + m["dims"][3]
    total += 2.0 * (upper_tokens * cin * m["upper_vars"] * pz * ph * pw
                    + surf_tokens * cin * m["surface_vars"] * ph * pw)
    return batch * total


def train_matmul_flops(m: dict, batch: int = 1) -> float:
    return 3.0 * forward_matmul_flops(m, batch)


def peaks(device_name: str) -> Dict[str, float]:
    """The card's published peaks (FLOP/s by dtype, ``bytes_per_s``). A card
    that is not in ``peaks.json`` is an error: the run never guesses."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    if device_name not in table:
        raise KeyError(f"no peaks for {device_name!r} in {PEAKS_FILE}")
    return {k: float(v) for k, v in table[device_name].items() if not k.startswith("_")}


def blocks(m: dict) -> List[Tuple[Stage, int, int, bool]]:
    """(stage, C, heads, shifted) of every block of the model, in order."""
    return [(stage_of(m, i), c, heads, bool(j % 2))
            for i, (depth, c, heads) in enumerate(zip(m["depths"], m["dims"], m["heads"]))
            for j in range(depth)]


def bound_s(work: Tuple[float, float, float], pk: Dict[str, float]) -> float:
    """The least time of one call doing ``work`` = (bf16 product FLOP, f32
    elementwise FLOP, compulsory bytes): the larger of its operations over
    their peaks and its bytes over the memory rate."""
    mm, ew, nbytes = work
    return max(mm / pk["bfloat16"] + ew / pk["float32"], nbytes / pk["bytes_per_s"])
