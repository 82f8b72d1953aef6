"""LoRA parameter-efficient finetuning (port of ``pangu_tpu/train/lora.py``;
reference finetune/lora_tune.py).

The reference wraps every ``nn.Linear`` with peft LoRA (r=16, alpha=16,
dropout=0.1) and fully trains the output convolutions
(finetune/lora_tune.py:169-180). Here, as in the JAX package:

  * every 2-D weight outside the full-train modules gets a low-rank delta
    ``W_eff = W + (alpha/r) * (A @ B)^T`` with A ~ N(0, 1/r), B = 0; A is
    (in, r) and B (r, out), the JAX layout, so JAX trees carry across as
    they are (the port's weights are (out, in), hence the transpose);
  * the full-train modules (patch embed / recovery, the reference's
    ``modules_to_save``; the port's ``_input_layer`` and ``_output_layer``)
    are trained directly;
  * the trainable tree is ``{"lora": {key: {"a", "b"}}, "full": {key: t}}``
    keyed by the port's state-dict names; ``merge_params`` gives the
    effective state dict for export and eval.

``attach_lora`` makes a model compute with a trainable tree: a
``model.attention.LoraAdapter`` on each target linear, the tree's head
tensors in place of the model's, every other parameter frozen. Two forms:

  * **merged** (default): each target weight is ``W + delta`` recomputed from
    A and B at every use (so a remat recompute differentiates A and B);
    every kernel runs, K2-K7 with W_eff in the train step.
  * **unmerged** (``make_lora_train_step(..., unmerged=True)``): peft's
    per-linear ``y += scaling * dropout(x) @ A @ B`` with per-element adapter
    dropout (the JAX ``lora_tap``); the adapted attention and MLP sites take
    the plain path, as in JAX. Eval always merges: with dropout off the two
    forms are the same function.

Under a spatial mesh the adapters on the layers' linears work on slabs, as
the linears do: their gradients are summed over the lat x lon plane before
the data axis averages them (``model.blocks.slab_tensors``); the adapters of
the joints and the full-train heads work on the whole grid and are not.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from pangu_tpu_torch.model.attention import LoraAdapter
from pangu_tpu_torch.train.step import make_train_step, loss_fn

#: the JAX package's full-train subtree names -> the port's module names
MODULE_NAMES = {"patch_embed": "_input_layer", "patch_recovery": "_output_layer"}


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 16  # reference finetune/lora_tune.py:175
    alpha: float = 16.0
    dropout: float = 0.1  # the unmerged form's adapter dropout
    # subtrees trained fully (reference modules_to_save: the output convs)
    full_train_prefixes: Tuple[str, ...] = ("patch_recovery", "patch_embed")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _state(base_params: Any) -> Dict[str, torch.Tensor]:
    if isinstance(base_params, nn.Module):
        return base_params.state_dict()
    return base_params


def _in_full_train(key: str, cfg: LoraConfig) -> bool:
    names = {MODULE_NAMES.get(p, p) for p in cfg.full_train_prefixes}
    return any(part in names for part in key.split("."))


def lora_target_paths(base_params: Any, cfg: LoraConfig) -> List[str]:
    """All 2-D weights outside the full-train modules (the state-dict keys of
    the ``nn.Linear`` weights; the heads' Conv1d weights are 3-D and trained
    fully) -- the analogue of the reference's 'all nn.Linear module names'
    target list (finetune/lora_tune.py:169-173). ``base_params``: a module
    or a state dict."""
    return [k for k, v in _state(base_params).items()
            if k.endswith(".weight") and v.ndim == 2 and not _in_full_train(k, cfg)]


def init_lora_params(base_params: Any, cfg: LoraConfig,
                     generator: torch.Generator) -> Dict:
    """Trainable tree: {"lora": {key: {"a", "b"}}, "full": {key: tensor}}; A
    drawn from ``generator`` (N(0, 1) / sqrt(rank)), B zeros, the heads
    copied (new ``nn.Parameter``s, so the base stays as it is). Every tensor
    requires a gradient and lives on its weight's device."""
    state = _state(base_params)
    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    for key in lora_target_paths(state, cfg):
        w = state[key]  # (out, in)
        a = torch.randn((w.shape[1], cfg.rank), generator=generator, dtype=w.dtype,
                        device=generator.device).to(w.device) / math.sqrt(cfg.rank)
        b = torch.zeros((cfg.rank, w.shape[0]), dtype=w.dtype, device=w.device)
        lora[key] = {"a": a.requires_grad_(), "b": b.requires_grad_()}
    full = {k: nn.Parameter(v.detach().clone()) for k, v in state.items()
            if _in_full_train(k, cfg)}
    return {"lora": lora, "full": full}


def flatten_trainable(trainable: Dict) -> Dict[str, torch.Tensor]:
    """The tree's tensors by one name each ("lora/<key>/a", "full/<key>"): a
    train state's ``params``, in a fixed order."""
    out = {f"lora/{k}/{ab}": t for k, v in trainable["lora"].items() for ab, t in v.items()}
    out.update({f"full/{k}": t for k, t in trainable["full"].items()})
    return out


def unflatten_trainable(flat: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`flatten_trainable`."""
    tree: Dict = {"lora": {}, "full": {}}
    for name, t in flat.items():
        kind, rest = name.split("/", 1)
        if kind == "lora":
            key, ab = rest.rsplit("/", 1)
            tree["lora"].setdefault(key, {})[ab] = t
        else:
            tree["full"][rest] = t
    return tree


@torch.no_grad()
def merge_params(base_params: Any, trainable: Dict, cfg: LoraConfig) -> Dict[str, torch.Tensor]:
    """Effective state dict (detached): base + scaled low-rank deltas +
    full-train overrides."""
    params = dict(_state(base_params))
    for key, ab in trainable["lora"].items():
        w = params[key]
        delta = (ab["a"] @ ab["b"]) * cfg.scaling
        params[key] = w + delta.t().to(w.dtype)
    params.update({k: t.detach() for k, t in trainable["full"].items()})
    return params


@torch.no_grad()
def apply_full_overrides(base_params: Any, trainable: Dict) -> Dict[str, torch.Tensor]:
    """Only the full-train overrides (no adapter merge): the base weights of
    the unmerged forward, where the adapters ride the linears instead."""
    params = dict(_state(base_params))
    params.update({k: t.detach() for k, t in trainable["full"].items()})
    return params


def count_trainable(trainable: Dict) -> int:
    return sum(t.numel() for t in flatten_trainable(trainable).values())


def set_lora_form(model: nn.Module, trainable: Dict, cfg: LoraConfig,
                  unmerged: bool = False) -> None:
    """Put an adapter over the tree's A and B on each target linear, merged
    or unmerged (``model.attention.LoraAdapter``)."""
    modules = dict(model.named_modules())
    for key, ab in trainable["lora"].items():
        modules[key.rsplit(".", 1)[0]].lora = LoraAdapter(
            ab["a"], ab["b"], cfg.scaling, cfg.dropout, merged=not unmerged)


def attach_lora(model: nn.Module, trainable: Dict, cfg: LoraConfig, unmerged: bool = False,
                base_params: Optional[Any] = None) -> None:
    """Make ``model`` compute with ``trainable``: ``base_params`` (when given)
    copied into its weights, every parameter frozen, the tree's head tensors
    registered in place of the model's, and the adapters set
    (``set_lora_form``)."""
    modules = dict(model.named_modules())
    if base_params is not None:
        with torch.no_grad():
            for k, p in model.state_dict().items():
                if k not in trainable["full"]:
                    p.copy_(_state(base_params)[k])
    for key, t in trainable["full"].items():
        name, attr = key.rsplit(".", 1)
        setattr(modules[name], attr, t)
    heads = {id(t) for t in trainable["full"].values()}
    for p in model.parameters():
        if id(p) not in heads:
            p.requires_grad_(False)
    set_lora_form(model, trainable, cfg, unmerged)


def detach_lora(model: nn.Module) -> None:
    """Take every adapter off ``model``'s linears."""
    for m in model.modules():
        m.__dict__.pop("lora", None)


def make_lora_train_step(
    model: nn.Module, cfg, optimizer: torch.optim.Optimizer, base_params: Any,
    lora_cfg: LoraConfig, trainable: Dict, unmerged: bool = False, steps_per_epoch: int = 1,
) -> Callable:
    """Like ``train.step.make_train_step`` but optimizing only the LoRA tree
    (``optimizer`` is over ``flatten_trainable(trainable)``):
    ``step(batch, aux, generator=None) -> loss``, the tree updated in place.
    ``unmerged`` switches to peft's per-element adapter-dropout form (module
    docstring); each call sets its form, so an eval step may share the model."""
    attach_lora(model, trainable, lora_cfg, unmerged, base_params)
    # the JAX LoRA step differentiates the f32 tree whatever cfg.model.grads_dtype says
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, grads_dtype="float32"))
    inner = make_train_step(model, f32, optimizer, steps_per_epoch)

    def step(batch, aux, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        set_lora_form(model, trainable, lora_cfg, unmerged)
        return inner(batch, aux, generator)

    return step


def make_lora_eval_step(model: nn.Module, cfg, base_params: Any, lora_cfg: LoraConfig,
                        trainable: Dict) -> Callable:
    """Validation-loss step over the LoRA tree: ``eval(batch, aux) -> loss``
    with the merged weights (so the Trainer's val / early-stop / best-model
    machinery applies unchanged to LoRA runs)."""
    attach_lora(model, trainable, lora_cfg, False, base_params)

    @torch.no_grad()
    def step(batch, aux) -> torch.Tensor:
        set_lora_form(model, trainable, lora_cfg, unmerged=False)
        model.eval()
        return loss_fn(model, batch, aux, cfg)

    return step


def changed_param_report(base_params: Any, merged: Any, atol: float = 0.0) -> List[str]:
    """Names of params that differ after finetuning -- the reference prints
    this diff against a deepcopy of the base model
    (finetune/lora_tune.py:182-248). ``np.allclose``'s test (rtol 1e-5)."""
    base, new = _state(base_params), _state(merged)
    return [k for k, v in base.items()
            if not torch.allclose(v.detach().float(), new[k].detach().float().to(v.device),
                                  rtol=1e-5, atol=atol)]
