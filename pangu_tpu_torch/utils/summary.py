"""Model/param introspection (port of ``pangu_tpu/utils/summary.py``; role
of torch_summarize, reference era5_data/utils.py:142-176).

Both functions take an ``nn.Module`` (its parameters), a flat state dict
(dotted names, as ``state_dict()`` gives them) or a nested dict of tensors
(a LoRA trainable tree).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
from torch import nn


def _leaves(params: Any) -> Iterator[Tuple[str, Any]]:
    if isinstance(params, nn.Module):
        yield from params.named_parameters()
    elif isinstance(params, dict):
        for k, v in params.items():
            if isinstance(v, dict):
                yield from ((f"{k}.{n}", t) for n, t in _leaves(v))
            else:
                yield k, v
    else:
        yield "", params


def param_count(params: Any) -> int:
    return sum(int(np.prod(t.shape)) for _, t in _leaves(params))


def _tree(params: Any) -> Dict:
    """Dotted names -> nested dicts with the tensors at the leaves."""
    tree: Dict = {}
    for name, t in _leaves(params):
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def summarize_params(params: Any, max_depth: int = 3) -> str:
    """Tree summary with per-subtree parameter counts."""
    lines: List[str] = []
    total = param_count(params)
    lines.append(f"total parameters: {total:,}")

    def walk(tree, depth):
        if depth > max_depth or not isinstance(tree, dict):
            return
        for k, v in tree.items():
            n = param_count(v)
            shape = "" if isinstance(v, dict) else f" {tuple(v.shape)}"
            lines.append("  " * depth + f"{k}: {n:,}{shape}")
            walk(v, depth + 1)

    walk(_tree(params), 0)
    return "\n".join(lines)
