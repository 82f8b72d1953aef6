"""Transformer blocks and resolution changers (port of
``pangu_tpu/model/blocks.py``).

Blocks work on the window-padded grid (B, Z, Hp, W, C) in the compute dtype.
The route keys on the module's mode, as the JAX package keys on
``deterministic``:

* eval, bf16, ``use_kernel`` set (``ModelConfig.use_pallas_attention``),
  autograd off: ONE call of ``ops.fused_block_attention.fused_earth_block``
  (K1) per block -- the CUDA kernel on the card, its plain version on the CPU.
  On the whole grid K1 takes the block input as it stands, with the block's
  shift and real rows: the kernel folds the roll and the pad re-zero into its
  window gather, and its output is already un-rolled. On a spatial slab the
  block re-zeroes and halo-shifts first and rolls back after, as the other
  routes do;
* eval otherwise (f32, or autograd on: K1 has no backward): the plain
  composition ``x + LN1(attn(x))`` then ``+ LN2(MLP(.))``;
* training: ``x = shortcut + s1 * LN1(attn(x))`` then ``x + s2 * LN2(MLP(x))``
  with per-sample stochastic-depth scales ``s1``, ``s2``. With bf16 and
  ``use_kernel`` the attention is K2 (backward K3), the first residual K4
  (backward K5, ``ops.fused_epilogue``) and the MLP tail K6 (backward K7,
  ``ops.fused_mlp``). Two A/B switches of the JAX package change that route:
  ``ops.fused_block_train._TRAIN_FUSION = True`` runs each block (dropout 0)
  as ONE call of the training block kernel K11 (backward K12), and
  ``ops.fused_mlp._POSTNORM_FUSION = False`` runs the MLP tail as the raw MLP
  K8 (backward K9) followed by the XLA formula of the residual. Without the
  kernels both residuals are the XLA formula (``postnorm_residual``), which
  rounds LN(.) to the compute dtype first. As in JAX
  (pangu_tpu/model/blocks.py:102-137, 297, 360-364), active dropout sends
  the attention and the MLP off their kernels, and so does an unmerged LoRA
  adapter on one of their linears; the first residual keeps K4/K5; K1 and
  K11/K12 run only with no dropout and no unmerged adapter in the block.
  Merged adapters change only the weights the kernels are given.

``EarthSpecificLayer`` draws the scales and, with ``remat``, checkpoints each
block (``torch.utils.checkpoint``, non-reentrant) -- except a block on the
K11 route, whose autograd Function saves only its inputs, so a recompute
would only run K11 again. A training block runs as stages: the attention
(with the entry's pad and roll), the first residual, the MLP (K6's whole
tail, or the raw MLP output that the JAX package names ``mlp_out``) and,
after a raw MLP, the second residual. ``remat_save_attention`` and
``remat_save_mlp`` keep the attention's and the MLP's outputs, as the JAX
policy ``save_only_these_names("attn_out", "mlp_out")`` does: the backward
recomputes the other stages but not those two. A kept kernel stage runs
outside the checkpoint (its autograd Function saves only its inputs); a
kept plain stage is a checkpoint of its own, whose output is kept. Dropout
masks come from per-site seeds drawn before the stages (``train_seeds``), so
a recompute draws the masks of the forward.

Under a mesh with a lat x lon plane (``parallel.spatial``) a layer takes the
rank's slab of whole windows of the padded grid at its entry and gathers the
slabs at its exit: every block's residual stream lives only as the slab.
A block then re-zeroes the pad rows by their global index, its roll is a
halo shift between neighbours, and its attention reads the earth bias and
the shift mask cut to the slab's lat windows, on every route. The route
does not depend on the slab's shape, so every rank of the plane recomputes
the same checkpoints in the same order (the recompute runs the halo shifts
again).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pangu_tpu_torch.geometry import StageGeometry
from pangu_tpu_torch.model.attention import (ATTENTION_SITES, EarthAttention3D, add_tap, draws,
                                             dropout, linear_weight, seed_of,
                                             shift_attention_mask, train_seeds, unmerged)
from pangu_tpu_torch.ops import fused_block_train, fused_mlp
from pangu_tpu_torch.ops.fused_block_attention import dense, fused_earth_block, layer_norm_f32
from pangu_tpu_torch.ops.fused_epilogue import fused_residual_postnorm
from pangu_tpu_torch.parallel import spatial
from pangu_tpu_torch.parallel.mesh import active_mesh
from pangu_tpu_torch.utils.profiling import span


def apply_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """f32-statistics LayerNorm (E[x^2] - mu^2, eps 1e-5), result in x.dtype."""
    return layer_norm_f32(x.float(), scale.float(), bias.float()).to(x.dtype)


def postnorm_residual(x: torch.Tensor, y: torch.Tensor, norm: nn.LayerNorm,
                      scale: torch.Tensor) -> torch.Tensor:
    """A training residual ``x + scale * LN(y)`` by the XLA formula: LN(y) in
    y's dtype, the sum in f32, one rounding (pangu_tpu/model/blocks.py:366-367
    and ``Mlp._finish``)."""
    branch = scale * apply_layer_norm(y, norm.weight, norm.bias).float()
    return (x.float() + branch).to(x.dtype)


#: the random sites of one MLP: its two dropouts and two adapters
MLP_SITES = ("drop1", "drop2", "fc1", "fc2")


class Mlp(nn.Module):
    """Linear(4x) -> exact GELU -> dropout -> Linear -> dropout; returns the
    raw MLP output, or with ``fused=True`` the whole block tail
    ``x + LN(mlp(x))`` as one call of the inference MLP kernel K10
    (``ops.fused_mlp.fused_mlp_block``), ``ln`` the LayerNorm's (scale, bias)."""

    def __init__(self, dim: int, ratio: int = 4, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.linear1 = nn.Linear(dim, dim * ratio)
        self.linear2 = nn.Linear(dim * ratio, dim)

    def plain_only(self) -> bool:
        """Whether this call must take the plain path: active dropout or an
        unmerged adapter (pangu_tpu/model/blocks.py:102-108)."""
        return ((self.training and self.dropout_rate > 0.0)
                or unmerged(self.linear1, self.linear2))

    def weights(self, dtype: torch.dtype) -> tuple:
        """(w1, b1, w2, b2) in ``dtype`` for a kernel (merged adapters applied)."""
        return (linear_weight(self.linear1).to(dtype), self.linear1.bias.to(dtype),
                linear_weight(self.linear2).to(dtype), self.linear2.bias.to(dtype))

    def forward(self, x: torch.Tensor, ln: Optional[tuple] = None, fused: bool = False,
                seeds: Optional[dict] = None) -> torch.Tensor:
        """``seeds`` (``train_seeds`` of ``MLP_SITES``) draw the dropout masks
        in training; required when one is active."""
        if fused:
            if ln is None:
                raise ValueError("the fused MLP tail needs ln = (scale, bias)")
            if self.plain_only():
                raise ValueError("the fused MLP tail has no dropout or unmerged-adapter path")
            return fused_mlp.fused_mlp_block(x, *self.weights(x.dtype), ln[0].float(),
                                             ln[1].float())
        rate = self.dropout_rate if self.training else 0.0
        if self.training and seeds is None and draws(rate, self.linear1, self.linear2):
            raise ValueError("dropout in training needs its seeds (train_seeds)")
        seed = seed_of(seeds, self.training)
        h = add_tap(dense(x, linear_weight(self.linear1), self.linear1.bias),
                    self.linear1, x, seed("fc1"))
        h = dropout(F.gelu(h), rate, seed("drop1"))
        y = add_tap(dense(h, linear_weight(self.linear2), self.linear2.bias),
                    self.linear2, h, seed("fc2"))
        return dropout(y, rate, seed("drop2"))


class EarthSpecificBlock(nn.Module):
    """One (optionally shifted) 3D window-attention block with post-norm
    residuals. Pad rows are re-zeroed at entry (the reference's crop and
    re-pad between blocks); K1 on the whole grid reads them as zeros
    instead, and its output's pad rows hold values nothing reads."""

    def __init__(self, stage: StageGeometry, dim: int, heads: int, shifted: bool,
                 mlp_ratio: int = 4, use_kernel: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        self.stage, self.dim, self.heads = stage, dim, heads
        self.shifted, self.use_kernel = shifted, use_kernel
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.linear = Mlp(dim, mlp_ratio, dropout_rate)
        self.attention = EarthAttention3D(dim, heads, stage, use_kernel, dropout_rate)
        mask = torch.from_numpy(shift_attention_mask(stage)) if shifted else None
        self.register_buffer("attn_mask", mask, persistent=False)

    def linears(self) -> tuple:
        return (self.attention.linear1, self.attention.linear2,
                self.linear.linear1, self.linear.linear2)

    def adapted(self) -> bool:
        """Whether an unmerged adapter rides one of the block's linears."""
        return unmerged(*self.linears())

    def draw_seeds(self, generator: Optional[torch.Generator]) -> Optional[dict]:
        """The block's dropout seeds for a training call that draws masks, else None."""
        return train_seeds(self, generator, BLOCK_SITES, self.attention.dropout_rate,
                           *self.linears())

    def train_fused(self, x: torch.Tensor) -> bool:
        """Whether a training call on ``x`` takes the K11/K12 route."""
        return (self.training and self.use_kernel and x.dtype == torch.bfloat16
                and fused_block_train._TRAIN_FUSION and self.attention.dropout_rate == 0.0
                and not self.adapted())

    def _enter(self, x: torch.Tensor, slab: Optional[spatial.Slab]):
        """Pad rows (global rows >= h) re-zeroed, then the shifted block's
        roll: (shortcut, x). ``x`` is the whole padded grid, or the slab.
        A ``pangu.block.shift`` range, as is ``_roll_back``'s roll."""
        st = self.stage
        (r0, r1), (c0, c1) = (slab.rows, slab.cols) if slab else ((0, st.h_pad), (0, st.w))
        assert tuple(x.shape[1:4]) == (st.z, r1 - r0, c1 - c0), (x.shape, st, slab)
        with span("pangu.block.shift"):
            real = min(max(st.h - r0, 0), r1 - r0)
            if real < r1 - r0:
                x = F.pad(x[:, :, :real], (0, 0, 0, 0, 0, r1 - r0 - real))
            if not self.shifted:
                return x, x
            return x, spatial.roll(x, [-(w // 2) for w in st.window], slab)

    def _roll_back(self, x: torch.Tensor, slab: Optional[spatial.Slab]) -> torch.Tensor:
        if not self.shifted:
            return x
        with span("pangu.block.shift"):
            return spatial.roll(x, [w // 2 for w in self.stage.window], slab)

    def _tables(self, slab: Optional[spatial.Slab]) -> tuple:
        """The earth bias (nT, heads, T, T) f32 and the shift mask (or None)
        for the slab's lat windows (the whole tables without one)."""
        bias, mask = self.attention.earth_specific_bias[0], self.attn_mask
        if slab is not None:
            bias = slab.cut_types(bias)
            mask = None if mask is None else slab.cut_types(mask)
        return bias.float(), mask

    def forward(self, x: torch.Tensor, s1: Optional[torch.Tensor] = None,
                s2: Optional[torch.Tensor] = None, kept: Optional[frozenset] = None,
                seeds: Optional[dict] = None) -> torch.Tensor:
        """In training, ``s1``/``s2`` are the stochastic-depth branch scales
        of the two residuals, (B, 1, 1, 1, 1) f32 (``drop_path_scale``),
        ``kept`` is None (no checkpoint) or the set of stage outputs the
        backward keeps ("attention", "mlp"; empty: the whole block is
        recomputed) and ``seeds`` the dropout seeds (``draw_seeds``)."""
        slab = spatial.slab_of(self.stage, active_mesh())
        if self.training:
            if s1 is None or s2 is None:
                raise ValueError("a training block needs its drop-path scales s1 and s2")
            if self.train_fused(x):
                return self._train_fused(x, s1, s2, slab)
            return run_stages(self._train_stages(x, s1, s2, seeds, slab), x, kept)

        k1 = (self.use_kernel and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
              and not self.adapted())
        # K1 on the whole grid folds the roll and the pad re-zero into its
        # gather: its shift range stays open, and empty
        folded = k1 and slab is None
        if folded:
            with span("pangu.block.shift"):
                pass
        else:
            shortcut, x = self._enter(x, slab)
        if k1:
            cdt, st = x.dtype, self.stage
            attn, mlp = self.attention, self.linear
            shift, h = (([w // 2 * self.shifted for w in st.window], st.h) if folded
                        else ((0, 0, 0), x.shape[2]))
            x = fused_earth_block(
                x,
                linear_weight(attn.linear1).to(cdt), attn.linear1.bias.to(cdt),
                linear_weight(attn.linear2).to(cdt), attn.linear2.bias.to(cdt),
                *self._tables(slab),
                self.norm1.weight.float(), self.norm1.bias.float(),
                *mlp.weights(cdt),
                self.norm2.weight.float(), self.norm2.bias.float(),
                st.window, self.heads, (self.dim // self.heads) ** -0.5, shift, h,
            )
            return x if folded else self._roll_back(x, slab)

        bias, mask = self._tables(slab)
        x = self._roll_back(self.attention(x, mask, bias=bias), slab)
        x = shortcut + apply_layer_norm(x, self.norm1.weight, self.norm1.bias)
        return x + apply_layer_norm(self.linear(x), self.norm2.weight, self.norm2.bias)

    def _train_fused(self, x: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                     slab: Optional[spatial.Slab]) -> torch.Tensor:
        """The training block as one call of K11 (backward K12)."""
        _, x = self._enter(x, slab)
        cdt, attn, mlp = x.dtype, self.attention, self.linear
        x = fused_block_train.fused_earth_block_train(
            x,
            linear_weight(attn.linear1).to(cdt), attn.linear1.bias.to(cdt),
            linear_weight(attn.linear2).to(cdt), attn.linear2.bias.to(cdt),
            *self._tables(slab),
            self.norm1.weight.float(), self.norm1.bias.float(),
            *mlp.weights(cdt),
            self.norm2.weight.float(), self.norm2.bias.float(),
            s1.reshape(-1), s2.reshape(-1),
            self.stage.window, self.heads, (self.dim // self.heads) ** -0.5,
        )
        return self._roll_back(x, slab)

    def _train_stages(self, x: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                      seeds: Optional[dict], slab: Optional[spatial.Slab]) -> list:
        """The training block as (function, name, kernel) stages, each a
        function of the previous stage's tensors returning a tuple; the names
        "attention" and "mlp" mark the stages whose outputs the remat flags
        keep, ``kernel`` whether the stage is one kernel call. The bf16
        kernel route runs K2 for the attention, K4 for the first residual and
        K6 (or K8) for the MLP; active dropout or an unmerged adapter sends
        the attention or the MLP to the plain path."""
        attn, mlp, norm1, norm2 = self.attention, self.linear, self.norm1, self.norm2
        residual_kernel = self.use_kernel and x.dtype == torch.bfloat16
        attn_kernel = attn.uses_kernel(x)
        mlp_kernel = residual_kernel and not mlp.plain_only()

        def attention(x):
            shortcut, x = self._enter(x, slab)
            bias, mask = self._tables(slab)
            return shortcut, attn(x, mask, seeds=seeds, bias=bias)

        def residual(shortcut, y):
            y = self._roll_back(y, slab)
            if residual_kernel:
                return (fused_residual_postnorm(shortcut, y, norm1.weight.float(),
                                                norm1.bias.float(), s1),)
            return (postnorm_residual(shortcut, y, norm1, s1),)

        stages = [(attention, "attention", attn_kernel), (residual, None, residual_kernel)]
        if mlp_kernel and fused_mlp._POSTNORM_FUSION:
            def tail(x):
                return (fused_mlp.fused_mlp_postnorm(x, *mlp.weights(torch.bfloat16),
                                                     norm2.weight.float(), norm2.bias.float(),
                                                     s2),)

            return stages + [(tail, "mlp", True)]

        def mlp_out(x):
            return x, (fused_mlp.fused_mlp(x, *mlp.weights(torch.bfloat16)) if mlp_kernel
                       else mlp(x, seeds=seeds))

        def finish(x, y):
            return (postnorm_residual(x, y, norm2, s2),)

        return stages + [(mlp_out, "mlp", mlp_kernel), (finish, None, False)]


#: the random sites of one block (distinct names, one seed each)
BLOCK_SITES = ATTENTION_SITES + MLP_SITES


def _chain(stages):
    """The stages as one function: a ``pangu.block.stages`` range, which a
    checkpoint's replay in the backward opens again."""
    def run(*state):
        with span("pangu.block.stages"):
            for fn, *_ in stages:
                state = fn(*state)
        return state
    return run


def run_stages(stages, x: torch.Tensor, kept: Optional[frozenset]) -> torch.Tensor:
    """Run a block's training ``stages`` on ``x``. ``kept`` None: plainly.
    Otherwise each run of consecutive stages whose names are not in ``kept``
    goes under one non-reentrant ``torch.utils.checkpoint`` (the backward
    recomputes it), and each kept stage runs alone: outside any checkpoint
    when it is one kernel call (its autograd Function saves only its inputs,
    so its backward does not run it again), else under a checkpoint of its
    own, which keeps the stage's output and recomputes only its inside."""
    if kept is None:
        return _chain(stages)(x)[0]
    state, i = (x,), 0
    while i < len(stages):
        j = i + 1
        _, name, kernel = stages[i]
        if name in kept:
            if kernel:
                state = stages[i][0](*state)
                i = j
                continue
        else:
            while j < len(stages) and stages[j][1] not in kept:
                j += 1
        state = checkpoint(_chain(stages[i:j]), *state, use_reentrant=False)
        i = j
    return state[0]


def drop_path_scale(batch: int, rate: float, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """Per-sample stochastic-depth branch scale (B, 1, 1, 1, 1) f32: 1/keep
    with probability keep = 1 - rate, else 0 (ones at rate 0). Under an
    active mesh the generator (the same on every rank) draws the global
    batch's B * data uniforms and the rank keeps the rows of its data
    coordinate, so a world of N ranks draws what one process draws for the
    whole batch, as the JAX package's global key does, and the spatial peers
    of one sample draw the same scales."""
    if rate <= 0.0:
        return torch.ones((batch, 1, 1, 1, 1), device=device)
    if generator is None:
        raise ValueError("drop path in training needs an explicit torch.Generator")
    keep = 1.0 - rate
    mesh = active_mesh()
    world, rank = (mesh.data, mesh.data_rank) if mesh is not None else (1, 0)
    u = torch.rand((batch * world,), generator=generator, device=generator.device)
    u = u[rank * batch:(rank + 1) * batch].to(device)
    return torch.where(u < keep, 1.0 / keep, 0.0).reshape(batch, 1, 1, 1, 1).float()


class EarthSpecificLayer(nn.Module):
    """A stack of blocks alternating unshifted/shifted windows. Latitude is
    window-padded once for the whole stack and cropped at the end. Under a
    spatial mesh the blocks run on the rank's slab, taken after the pad and
    gathered before the crop (``parallel.spatial.scatter``/``gather``), inside
    ``parallel.spatial.on_slab``; ``parallel.spatial.record_shardings`` logs each block's input shape
    beside the whole grid's.

    In training each block gets two fresh drop-path scales and, when it
    draws dropout masks, its per-site seeds, drawn here, outside the
    checkpoint: a recompute under ``torch.utils.checkpoint`` does not replay
    an explicit generator, so draws inside the block would differ between
    the forward and its recompute. With ``remat`` a block is
    checkpointed but for the stage outputs that ``save_attention`` and
    ``save_mlp`` keep (see the module docstring); a block on the K11 route
    is not checkpointed."""

    def __init__(self, stage: StageGeometry, dim: int, heads: int,
                 drop_path_rates: Sequence[float], mlp_ratio: int = 4,
                 use_kernel: bool = False, remat: bool = False, dropout_rate: float = 0.0,
                 save_attention: bool = False, save_mlp: bool = False):
        super().__init__()
        self.stage = stage
        self.kept = (frozenset(("attention",) * save_attention + ("mlp",) * save_mlp)
                     if remat else None)
        self.drop_path_rates = tuple(drop_path_rates)
        depth = len(self.drop_path_rates)
        self.blocks = nn.ModuleDict({
            f"EarthSpecificBlock{i}": EarthSpecificBlock(
                stage, dim, heads, shifted=bool(i % 2), mlp_ratio=mlp_ratio,
                use_kernel=use_kernel, dropout_rate=dropout_rate)
            for i in range(depth)
        })

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        st = self.stage
        assert tuple(x.shape[1:4]) == (st.z, st.h, st.w), (x.shape, st)
        x = F.pad(x, (0, 0, 0, 0, 0, st.h_pad - st.h))
        whole = tuple(x.shape)
        slab = spatial.slab_of(st, active_mesh())
        if slab is not None:
            x = spatial.scatter(x, slab)
        with spatial.on_slab(slab):
            for (name, block), rate in zip(self.blocks.items(), self.drop_path_rates):
                spatial.record(f"block:{name}", whole, x.shape)
                if not self.training:
                    x = block(x)
                    continue
                s1 = drop_path_scale(x.shape[0], rate, generator, x.device)
                s2 = drop_path_scale(x.shape[0], rate, generator, x.device)
                x = block(x, s1, s2, self.kept, block.draw_seeds(generator))
        if slab is not None:
            x = spatial.gather(x, slab)
        return x[:, :, :st.h]


def slab_tensors(model: nn.Module) -> list:
    """The tensors ``model``'s layers use on slabs under a spatial mesh: the
    parameters of every ``EarthSpecificLayer`` and the A and B of the LoRA
    adapters riding its linears. Their gradients are partial sums over the
    rank's slab (``parallel.sharding.spatial_reduce``); every other
    tensor is used on the whole grid, the same on every spatial peer."""
    out = []
    for layer in model.modules():
        if isinstance(layer, EarthSpecificLayer):
            out += list(layer.parameters())
            out += [t for m in layer.modules() if m.__dict__.get("lora") is not None
                    for t in (m.lora.a, m.lora.b)]
    return out


class DownSample(nn.Module):
    """2x2 lat/lon space-to-depth + LayerNorm + Linear(4C -> 2C, no bias);
    merged feature order (lat-offset, lon-offset, C)."""

    def __init__(self, dim: int, h_pad: int):
        super().__init__()
        self.h_pad = h_pad
        self.norm = nn.LayerNorm(4 * dim)
        self.linear = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws an unmerged adapter's dropout in training."""
        seed = seed_of(train_seeds(self, generator, ("reduction",), 0.0, self.linear),
                       self.training)
        b, z, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, 0, 0, self.h_pad))
        hp = h + self.h_pad
        x = x.reshape(b, z, hp // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(b, z, hp // 2, w // 2, 4 * c)
        x = apply_layer_norm(x, self.norm.weight, self.norm.bias)
        return add_tap(dense(x, linear_weight(self.linear)), self.linear, x, seed("reduction"))


class UpSample(nn.Module):
    """Linear(C_in -> 4 C_out, no bias) + 2x2 depth-to-space + lat crop +
    LayerNorm + mixing Linear (no bias)."""

    def __init__(self, in_dim: int, out_dim: int, h_out: int):
        super().__init__()
        self.out_dim, self.h_out = out_dim, h_out
        self.linear1 = nn.Linear(in_dim, 4 * out_dim, bias=False)
        self.norm = nn.LayerNorm(out_dim)
        self.linear2 = nn.Linear(out_dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the unmerged adapters' dropout in training."""
        seed = seed_of(train_seeds(self, generator, ("expand", "mix"), 0.0, self.linear1,
                                   self.linear2), self.training)
        b, z, h2, w2, _ = x.shape
        x = add_tap(dense(x, linear_weight(self.linear1)), self.linear1, x, seed("expand"))
        x = x.reshape(b, z, h2, w2, 2, 2, self.out_dim).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(b, z, 2 * h2, 2 * w2, self.out_dim)[:, :, :self.h_out]
        x = apply_layer_norm(x, self.norm.weight, self.norm.bias)
        return add_tap(dense(x, linear_weight(self.linear2)), self.linear2, x, seed("mix"))
