"""Flat .npz param serialization — a portable, torch-free interchange format
for param pytrees (keys are '/'-joined tree paths).

The port's own copy of ``pangu_tpu/interop/npz_io.py`` (the port imports nothing of the
JAX package); tests/test_torch_port_modules.py holds it to the original.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_params_npz(path: str, params: Any) -> None:
    np.savez_compressed(path, **flatten_tree(params))


def load_params_npz(path: str) -> Dict:
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})
