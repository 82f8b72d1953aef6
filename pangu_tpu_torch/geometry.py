"""Static grid geometry for the Earth-Specific Transformer.

The port's own copy of ``pangu_tpu/geometry.py`` (the port imports nothing of the
JAX package); tests/test_torch_port_modules.py holds it to the original.

Every pad/crop/window constant that the reference hard-codes
(reference models/layers.py:37,49,178-185,228,347-350,506,546,555,596-600)
is derived here once from the ModelConfig, so the same model code runs the
721x1440 pretrained geometry and tiny test geometries.  All quantities are
Python ints computed before tracing — XLA sees only static shapes.

Conventions:
  * token grid is (Z, H, W) with the surface plane at z=0 and patch-embedded
    upper levels at z=1.. (reference models/layers.py:116).
  * lat padding is trailing only (reference pads (front=0, back) everywhere).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from pangu_tpu_torch.config import ModelConfig


def _pad_to(n: int, m: int) -> int:
    """Trailing padding that makes n a multiple of m."""
    return (-n) % m


@dataclass(frozen=True)
class StageGeometry:
    """Geometry of one encoder/decoder stage (token grid + window layout)."""

    z: int
    h: int  # unpadded token-lat extent at this stage
    w: int
    # window attention layout
    h_pad: int  # h padded to a multiple of window lat (181 -> 186, 91 -> 96)
    n_lon_windows: int
    n_type_windows: int  # (z/wz) * (h_pad/wh): 124 / 64 in the pretrained model
    window: Tuple[int, int, int]

    @property
    def tokens_per_window(self) -> int:
        wz, wh, ww = self.window
        return wz * wh * ww  # 144 in the pretrained model

    @property
    def num_tokens(self) -> int:
        return self.z * self.h * self.w


@dataclass(frozen=True)
class Geometry:
    """Full derived geometry of the backbone."""

    cfg: ModelConfig
    # patch-embed
    lat_pad: int  # 721 -> 724
    level_pad: int  # 13 -> 14
    z_upper: int  # 7
    z: int  # 8 (surface + upper)
    h: int  # 181
    w: int  # 360
    # downsampled stage
    h_down_pad: int  # 181 -> 182 before 2x2 space-to-depth
    h2: int  # 91
    w2: int  # 180
    outer: StageGeometry  # stages 0 and 3 (dim C)
    inner: StageGeometry  # stages 1 and 2 (dim 2C)


def compute_geometry(cfg: ModelConfig) -> Geometry:
    pz, ph, pw = cfg.patch
    wz, wh, ww = cfg.window

    lat_pad = _pad_to(cfg.lat, ph)
    level_pad = _pad_to(cfg.levels, pz)
    if _pad_to(cfg.lon, pw):
        raise ValueError(f"lon={cfg.lon} must be a multiple of patch lon {pw}")

    z_upper = (cfg.levels + level_pad) // pz
    z = z_upper + 1  # + surface plane
    h = (cfg.lat + lat_pad) // ph
    w = cfg.lon // pw

    h_down_pad = _pad_to(h, 2)
    h2 = (h + h_down_pad) // 2
    w2 = w // 2

    def stage(sz: int, sh: int, sw: int) -> StageGeometry:
        hp = sh + _pad_to(sh, wh)
        if sz % wz or sw % ww:
            raise ValueError(
                f"stage grid ({sz},{sh},{sw}) incompatible with window {cfg.window}"
            )
        return StageGeometry(
            z=sz,
            h=sh,
            w=sw,
            h_pad=hp,
            n_lon_windows=sw // ww,
            n_type_windows=(sz // wz) * (hp // wh),
            window=cfg.window,
        )

    return Geometry(
        cfg=cfg,
        lat_pad=lat_pad,
        level_pad=level_pad,
        z_upper=z_upper,
        z=z,
        h=h,
        w=w,
        h_down_pad=h_down_pad,
        h2=h2,
        w2=w2,
        outer=stage(z, h, w),
        inner=stage(z, h2, w2),
    )
