"""Import reference-format PyTorch checkpoints into pangu_tpu param pytrees.

The port's own copy of ``pangu_tpu/interop/torch_import.py`` (the port imports nothing of the
JAX package); tests/test_torch_port_modules.py holds it to the original.

The reference converts the official ONNX weights to ``pangu_weather_{h}_torch
.pth`` files (reference models/onnx2torch.py:124-167) and saves finetuned
checkpoints as ``{"model": state_dict, ...}`` (models/pangu_sample.py:258-275).
This module maps those state-dict names onto our flax tree:

  torch layout                         ours
  ------------------------------------ ----------------------------------
  Linear.weight (out, in)              Dense kernel (in, out)   [transpose]
  Conv1d.weight (out, in, 1)           Dense kernel (in, out)   [squeeze+T]
  LayerNorm.weight/.bias               LayerNorm scale/bias
  earth_specific_bias (1,nT,h,T,T)     earth_bias (nT,h,T,T)    [squeeze]

Only numpy arrays cross this boundary — torch is needed just to read the
pickle, and only on the caller's side (`load_torch_checkpoint`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np

from pangu_tpu_torch.config import ModelConfig

Path = Tuple[str, ...]


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _t_conv1d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w[:, :, 0].T)


def _t_copy(w: np.ndarray) -> np.ndarray:
    return np.asarray(w)


def _t_bias_squeeze(w: np.ndarray) -> np.ndarray:
    return np.asarray(w)[0]


def reference_key_map(cfg: ModelConfig) -> List[Tuple[str, Path, Callable]]:
    """(reference torch state-dict key, our param path, transform) triples.

    Reference module names come from models/pangu_model.py:26-49 and
    models/layers.py (nn.Sequential(OrderedDict) naming).
    """
    out: List[Tuple[str, Path, Callable]] = []

    def add(ref: str, path: Path, tr: Callable) -> None:
        out.append((ref, path, tr))

    # Patch embedding (reference models/layers.py:23-26)
    add("_input_layer.conv.weight", ("patch_embed", "proj_upper", "kernel"), _t_conv1d)
    add("_input_layer.conv.bias", ("patch_embed", "proj_upper", "bias"), _t_copy)
    add("_input_layer.conv_surface.weight",
        ("patch_embed", "proj_surface", "kernel"), _t_conv1d)
    add("_input_layer.conv_surface.bias",
        ("patch_embed", "proj_surface", "bias"), _t_copy)

    # Transformer layers
    for i, depth in enumerate(cfg.depths):
        for j in range(depth):
            ref = f"layers.EarthSpecificLayer{i}.blocks.EarthSpecificBlock{j}."
            mine = (f"layer{i}", f"block{j}")
            for norm in ("norm1", "norm2"):
                add(ref + f"{norm}.weight", mine + (norm, "scale"), _t_copy)
                add(ref + f"{norm}.bias", mine + (norm, "bias"), _t_copy)
            add(ref + "linear.linear1.weight", mine + ("mlp", "fc1", "kernel"), _t_linear)
            add(ref + "linear.linear1.bias", mine + ("mlp", "fc1", "bias"), _t_copy)
            add(ref + "linear.linear2.weight", mine + ("mlp", "fc2", "kernel"), _t_linear)
            add(ref + "linear.linear2.bias", mine + ("mlp", "fc2", "bias"), _t_copy)
            add(ref + "attention.linear1.weight", mine + ("attn", "qkv", "kernel"), _t_linear)
            add(ref + "attention.linear1.bias", mine + ("attn", "qkv", "bias"), _t_copy)
            add(ref + "attention.linear2.weight", mine + ("attn", "proj", "kernel"), _t_linear)
            add(ref + "attention.linear2.bias", mine + ("attn", "proj", "bias"), _t_copy)
            add(ref + "attention.earth_specific_bias",
                mine + ("attn", "earth_bias"), _t_bias_squeeze)

    # Down/Up sample (reference models/layers.py:487-567)
    add("downsample.norm.weight", ("downsample", "norm", "scale"), _t_copy)
    add("downsample.norm.bias", ("downsample", "norm", "bias"), _t_copy)
    add("downsample.linear.weight", ("downsample", "reduction", "kernel"), _t_linear)
    add("upsample.linear1.weight", ("upsample", "expand", "kernel"), _t_linear)
    add("upsample.norm.weight", ("upsample", "norm", "scale"), _t_copy)
    add("upsample.norm.bias", ("upsample", "norm", "bias"), _t_copy)
    add("upsample.linear2.weight", ("upsample", "mix", "kernel"), _t_linear)

    # Patch recovery (reference models/layers.py:577-580)
    add("_output_layer.conv.weight", ("patch_recovery", "head_upper", "kernel"), _t_conv1d)
    add("_output_layer.conv.bias", ("patch_recovery", "head_upper", "bias"), _t_copy)
    add("_output_layer.conv_surface.weight",
        ("patch_recovery", "head_surface", "kernel"), _t_conv1d)
    add("_output_layer.conv_surface.bias",
        ("patch_recovery", "head_surface", "bias"), _t_copy)

    return out


def params_from_state_dict(
    cfg: ModelConfig, state: Mapping[str, np.ndarray], strict: bool = True
) -> Dict:
    """Build the model param pytree {'params': ...} from a numpy state dict."""
    tree: Dict = {}
    missing = []
    for ref_key, path, tr in reference_key_map(cfg):
        key = ref_key if ref_key in state else "module." + ref_key
        if key not in state:
            missing.append(ref_key)
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = tr(np.asarray(state[key], dtype=np.float32))
    if strict and missing:
        raise KeyError(f"{len(missing)} reference keys missing, e.g. {missing[:5]}")
    return {"params": tree}


def state_dict_from_params(cfg: ModelConfig, params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse mapping — export our params to a reference-format state dict
    (for round-trip tests and for users migrating back)."""
    inv = {
        _t_linear: _t_linear,  # transpose is its own inverse
        _t_conv1d: lambda w: np.ascontiguousarray(w.T)[..., None],
        _t_copy: _t_copy,
        _t_bias_squeeze: lambda w: np.asarray(w)[None],
    }
    out = {}
    tree = params["params"] if "params" in params else params
    for ref_key, path, tr in reference_key_map(cfg):
        node = tree
        for p in path:
            node = node[p]
        out[ref_key] = inv[tr](np.asarray(node, dtype=np.float32))
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a reference ``.pth`` (converted-pretrained or finetune checkpoint)
    into a numpy state dict. Handles the ``{"model": ...}`` wrapper and
    ``module.`` DDP prefixes (reference finetune/finetune_fully.py:193-218)."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    if hasattr(blob, "state_dict"):  # whole pickled nn.Module (best_model.pth)
        blob = blob.state_dict()
    return {
        k.replace("module.", "", 1) if k.startswith("module.") else k:
            v.detach().cpu().numpy()
        for k, v in blob.items()
    }
