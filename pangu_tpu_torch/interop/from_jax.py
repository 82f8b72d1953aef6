"""Parameters and optimizer state for the port: converted from a JAX tree,
or drawn from a seed (port-side counterpart of
``pangu_tpu/interop/torch_import.py``); LoRA trainable trees and their Adam
state carried across both ways.

The port's state dict IS the reference torch state dict, so the exporter
``state_dict_from_params`` (the port's copy of the JAX package's
``interop/torch_import.py``) is the converter; only numpy arrays cross the
boundary.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.interop import npz_io
from pangu_tpu_torch.interop.torch_import import (_t_conv1d, _t_linear, params_from_state_dict,
                                                  reference_key_map, state_dict_from_params)
from pangu_tpu_torch.model.attention import EarthAttention3D


def load_jax_params(model: nn.Module, cfg: ModelConfig, jax_params: Mapping) -> None:
    """Load a JAX ``{'params': ...}`` tree of numpy arrays into ``model``
    (strict: every reference key, nothing else)."""
    state = state_dict_from_params(cfg, jax_params)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)


def save_params_npz(path: str, model: nn.Module) -> None:
    """Write ``model``'s weights as the JAX package's ``.npz`` param tree
    (``params_from_state_dict``, keys flattened by ``npz_io.flatten_tree``): a
    file either package writes loads in both. Stored uncompressed: float
    weights deflate by ~7%, and deflating the flagship's 1.06 GB takes ~45 s."""
    state = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    np.savez(path, **npz_io.flatten_tree(params_from_state_dict(model.cfg, state)))


def _adam_state(opt_state: Any):
    """The element of an optax state that holds Adam's ``count``, ``mu``
    and ``nu`` (found by its fields, so that no optax import is needed)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def load_jax_opt_state(optimizer: torch.optim.Optimizer, model: nn.Module, cfg: ModelConfig,
                       opt_state: Any) -> None:
    """Load the Adam moments and update count of an optax state (the JAX
    train step's ``add_decayed_weights -> scale_by_adam -> scale_by_schedule``
    chain) into ``optimizer``, a ``torch.optim.Adam`` over ``model``'s
    parameters: a JAX run resumes in the port with the same next update. The
    moment trees convert like the params, through ``state_dict_from_params``."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam state (count, mu, nu)")
    mu, nu = state_dict_from_params(cfg, adam.mu), state_dict_from_params(cfg, adam.nu)
    count = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(mu[name], device=p.device),
            "exp_avg_sq": torch.tensor(nu[name], device=p.device),
        }


def _lora_items(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Mapping]]:
    """(joined JAX path, {"a", "b"}) of a JAX tree's ``lora`` entry, keyed by
    joined paths or nested (as ``npz_io.load_params_npz`` returns it)."""
    for k, v in tree.items():
        if set(v) == {"a", "b"}:
            yield prefix + k, v
        else:
            yield from _lora_items(v, f"{prefix}{k}/")


def _to_port(tr, w: np.ndarray) -> np.ndarray:
    """A JAX leaf in the port's layout (the inverse of a key-map transform)."""
    w = np.asarray(w, np.float32)
    if tr is _t_conv1d:
        return np.ascontiguousarray(w.T)[..., None]
    return np.ascontiguousarray(w.T) if tr is _t_linear else w


def lora_tree_from_jax(cfg: ModelConfig, jax_trainable: Mapping, device="cpu") -> Dict:
    """A JAX LoRA trainable tree ``{"lora": {"params/<path>/kernel": {a, b}},
    "full": {"patch_embed": ..., "patch_recovery": ...}}`` of numpy arrays
    as the port's tree (``train.lora``): A and B as they are (one layout in
    both packages), the heads through the reference key map; leaf tensors on
    ``device`` that require a gradient, the heads ``nn.Parameter``s."""
    by_path = {path: ref for ref, path, _ in reference_key_map(cfg)}
    lora = {by_path[tuple(joined.split("/")[1:])]: {
        k: torch.tensor(np.asarray(ab[k], np.float32), device=device).requires_grad_()
        for k in ("a", "b")} for joined, ab in _lora_items(jax_trainable["lora"])}
    full = {}
    for ref, path, tr in reference_key_map(cfg):
        if path[0] in jax_trainable["full"]:
            node = jax_trainable["full"]
            for p in path:
                node = node[p]
            full[ref] = nn.Parameter(torch.tensor(_to_port(tr, node), device=device))
    return {"lora": lora, "full": full}


def lora_tree_to_jax(cfg: ModelConfig, trainable: Mapping) -> Dict:
    """The port's LoRA tree as the JAX package's, numpy (the inverse of
    :func:`lora_tree_from_jax`)."""
    def host(t):
        return t.detach().float().cpu().numpy()

    paths = {ref: (path, tr) for ref, path, tr in reference_key_map(cfg)}
    lora = {"/".join(("params",) + paths[k][0]): {ab: host(t) for ab, t in v.items()}
            for k, v in trainable["lora"].items()}
    full: Dict = {}
    for k, t in trainable["full"].items():
        path, tr = paths[k]
        node = full
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = tr(host(t))
    return {"lora": lora, "full": full}


def save_lora_npz(path: str, cfg: ModelConfig, trainable: Mapping) -> None:
    """Write the port's LoRA tree as the JAX package's ``.npz`` (uncompressed)."""
    np.savez(path, **npz_io.flatten_tree(lora_tree_to_jax(cfg, trainable)))


def load_lora_npz(path: str, cfg: ModelConfig, device="cuda") -> Dict:
    """A LoRA tree ``.npz`` written by either package, as the port's tree, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return lora_tree_from_jax(cfg, npz_io.load_params_npz(path), device)


def load_jax_lora_opt_state(optimizer: torch.optim.Optimizer, trainable: Mapping,
                            cfg: ModelConfig, opt_state: Any) -> None:
    """Load the Adam moments and update count of a JAX LoRA run's optax state
    into ``optimizer``, a ``torch.optim.Adam`` over ``trainable`` (the port's
    tree): the run resumes in the port with the same next update."""
    from pangu_tpu_torch.train.lora import flatten_trainable

    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam state (count, mu, nu)")
    mu = flatten_trainable(lora_tree_from_jax(cfg, adam.mu))
    nu = flatten_trainable(lora_tree_from_jax(cfg, adam.nu))
    count = float(np.asarray(adam.count))
    for name, t in flatten_trainable(trainable).items():
        optimizer.state[t] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].detach().to(t.device),
            "exp_avg_sq": nu[name].detach().to(t.device),
        }


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> None:
    """Seeded synthetic parameters with the JAX package's initializers:
    truncated normal (std 0.02, cut at 2 std) for Dense/Conv kernels and
    earth-specific biases, zeros for biases, ones/zeros for LayerNorms.
    Drawn on the CPU, so one seed gives the same weights on any device."""
    gen = torch.Generator().manual_seed(seed)

    def trunc_normal(p: torch.Tensor) -> None:
        cpu = torch.empty(p.shape, dtype=torch.float32)
        nn.init.trunc_normal_(cpu, std=0.02, a=-0.04, b=0.04, generator=gen)
        p.copy_(cpu)

    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            trunc_normal(m.weight)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, EarthAttention3D):
            trunc_normal(m.earth_specific_bias)
