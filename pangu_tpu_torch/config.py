"""Single config system for the framework.

The port's own copy of ``pangu_tpu/config.py`` (the port imports nothing of the
JAX package); tests/test_torch_port_modules.py holds it to the original.

Replaces the reference's three overlapping mechanisms — the `cfg`
OrderedEasyDict singleton (reference era5_data/config.py), per-horizon config
module clones (era5_data/config_{1,3,6,24}.py) and scattered argparse flags /
module constants — with frozen dataclasses plus dotted-path overrides
(`apply_overrides`) and YAML/JSON round-trip.

All geometry-bearing fields live in ModelConfig so the model is fully
shape-generic: the 0.25-degree pretrained geometry (721x1440x13) is just the
default instance, and tiny instances drive fast CPU tests and the multi-chip
dry-run.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Sequence, Tuple

# ---------------------------------------------------------------------------
# Physical grid facts (reference era5_data/config.py:32-35)
# ---------------------------------------------------------------------------

#: Pressure levels in hPa, surface-to-top order as listed by the reference.
ERA5_UPPER_LEVELS: Tuple[str, ...] = (
    "1000", "925", "850", "700", "600", "500", "400", "300", "250", "200",
    "150", "100", "50",
)
ERA5_SURFACE_VARIABLES: Tuple[str, ...] = ("msl", "u10", "v10", "t2m")
ERA5_UPPER_VARIABLES: Tuple[str, ...] = ("z", "q", "t", "u", "v")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture + input-grid geometry.

    Defaults reproduce the pretrained Pangu-Weather backbone
    (reference models/pangu_model.py:19: depths [2,6,6,2], heads [6,12,12,6],
    dims [192,384,384,192], patch (2,4,4), window (2,6,12)).
    """

    # Input grid
    lat: int = 721
    lon: int = 1440
    levels: int = 13
    upper_vars: int = 5
    surface_vars: int = 4
    # Constant-field channels concatenated before patch projection
    # (reference models/layers.py:75-77,101-102: 3 surface masks, 1 const_h).
    surface_const_channels: int = 3
    upper_const_channels: int = 1

    # Backbone
    patch: Tuple[int, int, int] = (2, 4, 4)  # (z, lat, lon)
    window: Tuple[int, int, int] = (2, 6, 12)  # (z, lat, lon)
    depths: Tuple[int, ...] = (2, 6, 6, 2)
    heads: Tuple[int, ...] = (6, 12, 12, 6)
    dims: Tuple[int, ...] = (192, 384, 384, 192)
    mlp_ratio: int = 4
    drop_path_max: float = 0.2
    # Attention-probability / projection / MLP dropout (reference
    # models/layers.py:309,333 — instantiated at rate 0 in every published
    # config; kept as capability). Rates > 0 route attention off the Pallas
    # kernel during training.
    dropout_rate: float = 0.0

    # Numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # set "bfloat16" for speed on TPU
    # "highest" keeps fp32 matmuls true-fp32 (XLA otherwise lowers them to
    # bf16 passes on TPU); moot when compute_dtype is bfloat16.
    matmul_precision: str = "highest"
    # Keep each block's attention output out of rematerialization: the
    # backward pass then skips re-running the attention forward kernel
    # (the single largest remat recompute; measured -72 device-ms/step,
    # docs/PERFORMANCE.md) at ~2.1 GB HBM for the saved activations at
    # flagship geometry batch 1. Turn OFF for memory-constrained large
    # per-device batches. Ignored when remat is off.
    remat_save_attention: bool = True
    # Same idea for the MLP output (skips the MLP-forward remat recompute,
    # another ~2.1 GB at flagship batch 1; 774.9 -> 706.6 device-ms/step on
    # v5e, docs/PERFORMANCE.md). Ignored when remat is off.
    remat_save_mlp: bool = True
    # Differentiate with respect to a bfloat16-cast copy of the parameters
    # ("bfloat16") instead of the float32 masters ("float32"). The backward
    # then never emits the per-use-site bf16->f32 convert+reduce of each
    # parameter cotangent; the f32 master params and f32 Adam moments are
    # untouched (grads are cast up ONCE before the optimizer), so this is
    # the standard mixed-precision recipe, not bf16 training. Only
    # meaningful when compute_dtype is bfloat16.
    grads_dtype: str = "float32"
    # Rematerialize each transformer block during training
    # (reference models/layers.py:143-149 uses torch.utils.checkpoint).
    remat: bool = True
    # Use the fused Pallas windowed-attention kernel on TPU backends.
    use_pallas_attention: bool = False

    @property
    def recovery_upper_channels(self) -> int:
        """Per-token output channels of the upper patch-recovery head."""
        pz, ph, pw = self.patch
        return self.upper_vars * pz * ph * pw  # 5*2*4*4 = 160

    @property
    def recovery_surface_channels(self) -> int:
        ph, pw = self.patch[1], self.patch[2]
        return self.surface_vars * ph * pw  # 4*4*4 = 64

    @property
    def embed_upper_channels(self) -> int:
        pz, ph, pw = self.patch
        return (self.upper_vars + self.upper_const_channels) * pz * ph * pw

    @property
    def embed_surface_channels(self) -> int:
        ph, pw = self.patch[1], self.patch[2]
        return (self.surface_vars + self.surface_const_channels) * ph * pw


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths, date ranges and sampling (reference era5_data/config.py:43-74)."""

    root: str = ""  # data root; empty -> synthetic data
    store: str = "npy"  # "npy" | "pt" | "netcdf" | "synthetic"
    train_start: str = "20180101 00:00:00"
    train_end: str = "20230101 00:00:00"
    train_freq: str = "24h"
    val_start: str = "20230101 00:00:00"
    val_end: str = "20240101 00:00:00"
    val_freq: str = "24h"
    test_start: str = "20240101 00:00:00"
    test_end: str = "20250101 00:00:00"
    test_freq: str = "24h"
    prefetch: int = 2
    seed: int = 99  # reference era5_data/config.py:17


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference era5_data/config.py:44-61,
    finetune/finetune_fully.py:202-207)."""

    epochs: int = 100
    lr: float = 2e-5
    weight_decay: float = 3e-6
    lr_milestones: Tuple[int, ...] = (25, 50)
    lr_gamma: float = 0.5
    accumulation_steps: int = 1
    batch_size: int = 8
    upper_weights: Tuple[float, ...] = (3.00, 0.60, 1.50, 0.77, 0.54)
    surface_weights: Tuple[float, ...] = (1.50, 0.77, 0.66, 3.00)
    upper_loss_weight: float = 1.0
    surface_loss_weight: float = 0.25
    save_interval: int = 1
    val_interval: int = 1
    early_stop: int = 20
    only_wind_speed_loss: bool = False
    use_custom_mask: bool = False
    seed: int = 99


@dataclass(frozen=True)
class EvalConfig:
    batch_size: int = 1
    visualize: bool = False
    lead_days: int = 10  # rollout lead time (reference inference_multiOutput.py:32)


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh axis sizes. Products must divide/equal device count.

    data: batch sharding (DP; reference DDP/torchrun role).
    lat/lon: spatial sharding of the token grid (the framework's
    sequence-parallel story; absent from the reference, see SURVEY §5.7).
    zero_opt_state: shard optimizer state over the data axis (ZeRO role,
    reference ds_config.json stage-2).
    """

    data: int = 1
    lat: int = 1
    lon: int = 1
    # GPipe-style pipeline stages (role of the reference's DeepSpeed
    # PanguModelPipe, models/pangu_model_deepspeed.py:18-125). 1 = off;
    # otherwise any contiguous partition size of the 8-op backbone chain
    # (pipeline.default_stages: 4 = the reference's U-Net-joint split,
    # 2 = the mid-network cut, up to 8 = one op per stage). Composes with
    # `data`; mutually exclusive with spatial sharding (lat/lon) in this
    # release (docs/PARITY.md).
    pipe: int = 1
    zero_opt_state: bool = True
    # Constrain gradients to the same data-axis sharding inside the train
    # step (GSPMD then emits the reduce-scatter-grads / all-gather-params
    # schedule of DeepSpeed ZeRO stage 2, reference ds_config.json:1-24).
    zero_gradients: bool = True


@dataclass(frozen=True)
class PanguConfig:
    """Top-level config bundle."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    #: Forecast horizon in hours: 1, 3, 6 or 24 (reference era5_data/config.py:41).
    horizon: int = 24
    out_dir: str = "output"

    def replace(self, **kw: Any) -> "PanguConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def pangu_pretrain(horizon: int = 24, **model_kw: Any) -> PanguConfig:
    """The published-weights geometry; `horizon` selects the 1/3/6/24h model
    (replaces the reference's config_{1,3,6,24}.py module clones).

    Data cadence follows the reference's per-horizon clones: the h-hour
    model trains/scores on h-hourly pairs (config_{1,3,6}.py:50,66,73 set
    FREQUENCY='{1,3,6}h'; config.py:50 sets '24h'), capped at daily for
    any longer horizon. (An inverted `>= 24` here once made every preset
    daily — the 1h model saw one diurnal phase and 24x fewer samples.)"""
    freq = f"{horizon}h" if horizon < 24 else "24h"
    return PanguConfig(
        model=ModelConfig(**model_kw),
        data=DataConfig(train_freq=freq, val_freq=freq, test_freq=freq),
        horizon=horizon,
    )


def pangu_tiny(**model_kw: Any) -> PanguConfig:
    """A small geometry that exercises every padding/crop branch of the real
    one (odd lat, levels needing +1 pad, lat needing window pad after both
    patch-embed and downsample) while running in seconds on CPU."""
    defaults = dict(
        lat=49,
        lon=96,
        levels=5,
        patch=(2, 4, 4),
        window=(2, 6, 12),
        depths=(1, 1, 1, 1),
        heads=(2, 4, 4, 2),
        dims=(16, 32, 32, 16),
        remat=False,
    )
    defaults.update(model_kw)
    return PanguConfig(model=ModelConfig(**defaults), horizon=24)


# ---------------------------------------------------------------------------
# Overrides / serialization
# ---------------------------------------------------------------------------

def _coerce(value: str, ref: Any) -> Any:
    if isinstance(ref, bool):
        return value.lower() in ("1", "true", "yes", "y", "t")
    if isinstance(ref, int) and not isinstance(ref, bool):
        return int(value)
    if isinstance(ref, float):
        return float(value)
    if isinstance(ref, tuple):
        items = [v for v in value.strip("()[] ").split(",") if v != ""]
        elt = ref[0] if ref else value
        return tuple(_coerce(v.strip(), elt) for v in items)
    return value


def apply_overrides(cfg: PanguConfig, overrides: Sequence[str]) -> PanguConfig:
    """Apply dotted-path overrides like ``model.lat=73`` or ``horizon=6``."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        path, value = item.split("=", 1)
        keys = path.strip().lstrip("-").split(".")
        cfg = _set_path(cfg, keys, value)
    return cfg


def _set_path(obj: Any, keys: Sequence[str], value: str) -> Any:
    key = keys[0]
    if not hasattr(obj, key):
        raise KeyError(f"unknown config field {key!r} on {type(obj).__name__}")
    cur = getattr(obj, key)
    if len(keys) == 1:
        new = _coerce(value, cur) if not dataclasses.is_dataclass(cur) else value
    else:
        new = _set_path(cur, keys[1:], value)
    return dataclasses.replace(obj, **{key: new})


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg: PanguConfig, path: str) -> None:
    d = to_dict(cfg)
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)
    else:
        with open(path, "w") as f:
            json.dump(d, f, indent=2)


def _build(dc_type: Any, d: Dict[str, Any]) -> Any:
    kwargs = {}
    for f in dataclasses.fields(dc_type):
        if f.name not in d:
            continue
        v = d[f.name]
        submap = {"model": ModelConfig, "data": DataConfig, "train": TrainConfig,
                  "eval": EvalConfig, "parallel": ParallelConfig}
        if isinstance(v, dict) and f.name in submap:
            kwargs[f.name] = _build(submap[f.name], v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kwargs[f.name] = v
    return dc_type(**kwargs)


def load_config(path: str) -> PanguConfig:
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f)
    else:
        with open(path) as f:
            d = json.load(f)
    return _build(PanguConfig, d)
