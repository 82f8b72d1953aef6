"""Checkpoints (port of ``pangu_tpu/train/checkpoint.py``; the reference's
torch.save dicts, models/pangu_sample.py:253-275, and the resume path of
finetune/finetune_fully.py:193-218).

Layout, as in the JAX package: ``<dir>/train_<epoch>/`` and ``<dir>/best/``.
``train_<epoch>/state.pt`` is ``torch.save`` of ``{"model": the trainable
tensors by name, "optimizer": the optimizer's state_dict, "step", "epoch"}``;
``best/params.pt`` of the trainable tensors by name. There is no
``lr_scheduler`` entry: the LR schedule is a function of Adam's update
count, which the optimizer state carries. Files are written uncompressed
(plain ``torch.save``) and read with ``weights_only=True``.

Under an active mesh every rank calls a save: a sharded optimizer gathers
its moments into the one-device layout (a collective over its data group;
the spatial peers of a data replica hold the same shards), rank 0 writes
the file, and all ranks meet at a barrier after it. Every rank reads a load,
and a sharded optimizer keeps its shards of the moments; so a checkpoint
written at one world size resumes at any other, one process included, and
the file is the same as one process writes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from pangu_tpu_torch.parallel.mesh import barrier, is_main
from pangu_tpu_torch.train.step import TrainState

STATE_FILE, PARAMS_FILE = "state.pt", "params.pt"


def _path(d: str) -> str:
    return os.path.abspath(os.path.expanduser(d))


def _detached(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in params.items()}


def _save(obj, path: str, name: str) -> str:
    """Rank 0 writes; every rank of an active mesh waits for it."""
    if is_main():
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, name + ".tmp")
        torch.save(obj, tmp)
        os.replace(tmp, os.path.join(path, name))  # a cut save never leaves a torn file
    barrier()
    return path


def save_train_state(ckpt_dir: str, epoch: int, state: TrainState) -> str:
    path = os.path.join(_path(ckpt_dir), f"train_{epoch}")
    return _save({"model": _detached(state.params), "optimizer": state.opt_state.state_dict(),
                  "step": state.step, "epoch": epoch}, path, STATE_FILE)


@torch.no_grad()
def _copy_into(template: Dict[str, torch.Tensor], saved: Dict[str, torch.Tensor]) -> None:
    if sorted(template) != sorted(saved):
        missing, extra = sorted(set(template) - set(saved)), sorted(set(saved) - set(template))
        raise KeyError(f"checkpoint does not match the template: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for k, t in template.items():
        t.copy_(saved[k])


def restore_train_state(ckpt_dir: str, epoch: int,
                        template: TrainState) -> tuple[TrainState, int]:
    """Load ``train_<epoch>`` into ``template`` in place (its tensors and its
    optimizer, which must be built over the same tensors in the same order);
    returns (template, the saved epoch)."""
    path = os.path.join(_path(ckpt_dir), f"train_{epoch}", STATE_FILE)
    got = torch.load(path, map_location="cpu", weights_only=True)
    _copy_into(template.params, got["model"])
    template.opt_state.load_state_dict(got["optimizer"])
    if template.step != got["step"]:
        raise ValueError(f"{path}: the optimizer holds {template.step} updates, "
                         f"the checkpoint says {got['step']}")
    return template, int(got["epoch"])


def save_params(ckpt_dir: str, params: Dict[str, torch.Tensor], name: str = "best") -> str:
    return _save(_detached(params), os.path.join(_path(ckpt_dir), name), PARAMS_FILE)


def restore_params(ckpt_dir: str, template: Dict[str, torch.Tensor],
                   name: str = "best") -> Dict[str, torch.Tensor]:
    """New tensors with the saved values, on the template's devices and dtypes
    (the template is left as it is)."""
    path = os.path.join(_path(ckpt_dir), name, PARAMS_FILE)
    got = torch.load(path, map_location="cpu", weights_only=True)
    if sorted(template) != sorted(got):
        raise KeyError(f"{path} does not match the template")
    return {k: got[k].to(device=t.device, dtype=t.dtype) for k, t in template.items()}


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    d = _path(ckpt_dir)
    if not os.path.isdir(d):
        return None
    epochs = [
        int(n.split("_", 1)[1])
        for n in os.listdir(d)
        if n.startswith("train_") and n.split("_", 1)[1].isdigit()
    ]
    return max(epochs) if epochs else None


def load_checkpoint_params(path: str) -> Dict[str, torch.Tensor]:
    """The trainable tensors of a port checkpoint directory, ``best/`` or
    ``train_<n>/``, on the CPU; raises FileNotFoundError for any other
    directory (a JAX orbax checkpoint among them)."""
    for name, key in ((PARAMS_FILE, None), (STATE_FILE, "model")):
        f = os.path.join(_path(path), name)
        if os.path.isfile(f):
            got = torch.load(f, map_location="cpu", weights_only=True)
            return got if key is None else got[key]
    raise FileNotFoundError(
        f"{path} holds neither {PARAMS_FILE} nor {STATE_FILE}: not a checkpoint of this "
        "package. A JAX (orbax) checkpoint does not load here; export its params to .npz "
        "with the JAX package (pangu_tpu.interop.npz_io.save_params_npz) and pass that file")
