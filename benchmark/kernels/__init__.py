"""One file per kernel of the program: the names its launches carry in a
device trace (``PATTERNS``, regular expressions), the program's launch
counter (``COUNTER``: module, attribute) and ``work(stage, C, heads,
shifted, batch)``, the work of one call at a block's shape as (bf16 product
FLOP, f32 elementwise FLOP, compulsory bytes).

Products count 2 FLOP per multiply-add of the layer's own mathematics,
whatever implements it: a backward counts twice its forward's products and
nothing recomputed. Bytes count each input read once and each output
written once.
"""

from __future__ import annotations

import glob
import importlib.util
import os
from types import ModuleType
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> ModuleType:
    """The kernel file ``<name>.py`` of this folder."""
    path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.kernels.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_all() -> Dict[str, ModuleType]:
    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(HERE, "*.py")))
    return {n: load(n) for n in names if not n.startswith("_")}


def sizes(st, c: int, heads: int, shifted: bool, batch: int) -> dict:
    """The quantities the work functions share, at one block's shape:
    rows (tokens of the padded grid), T, one bf16 (rows, C) activation's
    bytes, the f32 earth-bias table (and shift mask) bytes, the bf16 weights
    of the attention and of the MLP, and one LayerNorm's f32 scale and bias."""
    r, t = batch * st.z * st.hp * st.w, st.tokens
    return dict(
        r=r, t=t, act=2 * r * c,
        tables=st.n_types * heads * t * t * 4 + (st.n_types * t * t * 4 if shifted else 0),
        w_attn=(4 * c * c + 4 * c) * 2, w_mlp=(8 * c * c + 5 * c) * 2, ln=2 * c * 4)
