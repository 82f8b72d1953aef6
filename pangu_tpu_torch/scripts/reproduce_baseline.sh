#!/usr/bin/env bash
# Reproduce the reference's published accuracy tables with the PyTorch port
# (port of scripts/reproduce_baseline.sh; BASELINE.md). Only the --dry-run
# branch is ported: the real run needs the published ONNX weights and ERA5,
# which are not in the repository, and this script downloads nothing.
#
# Usage: bash pangu_tpu_torch/scripts/reproduce_baseline.sh --dry-run [workdir]
#        PANGU_DEVICE=cpu bash pangu_tpu_torch/scripts/reproduce_baseline.sh --dry-run
#
# --dry-run validates every stage's wiring at tiny geometry without network
# or real data (tests/test_torch_reproduce_baseline.py runs it): the weight
# download is replaced by a synthetic official-structure ONNX (seed 3;
# build_synthetic_onnx of tests/test_torch_reproduce_baseline.py over the
# port's onnx_wire encoder), the ERA5 download by a generated
# reference-layout .pt store (seed 0); weight conversion, the ETL into the
# .npy store, scoring (on the card, like every entry point of the port, unless
# PANGU_DEVICE names another device, e.g. PANGU_DEVICE=cpu on a host without
# one) and the verdict parse all run for real.
set -euo pipefail

cd "$(dirname "$0")/../.."

if [ "${1:-}" != "--dry-run" ]; then
  echo "reproduce_baseline.sh: only --dry-run is ported; the real run waits until" \
       "the published weights and ERA5 are in the repository" >&2
  exit 2
fi

WORK=${2:-$(mktemp -d)}
mkdir -p "$WORK"
export PYTHONPATH=".:${PYTHONPATH:-}"
DEVICE=${PANGU_DEVICE:-cuda}

# 1'. synthetic pretrained weights (stands in for the download)
python - "$WORK" <<'PY'
import sys

import numpy as np

from pangu_tpu_torch.config import pangu_tiny

# tests/ is no package: a site-packages `tests` would shadow `tests.<module>`
sys.path.insert(0, "tests")
from test_torch_reproduce_baseline import build_synthetic_onnx  # noqa: E402

build_synthetic_onnx(pangu_tiny().model, np.random.default_rng(3),
                     sys.argv[1] + "/pangu_weather_24.onnx")
print("synthetic ONNX written")
PY

# 2. ONNX -> params npz + aux arrays (real stage, tiny geometry)
python -m pangu_tpu_torch.scripts.convert_weights --onnx "$WORK/pangu_weather_24.onnx" \
  --preset tiny --horizon 24 --out "$WORK/params_24.npz" --aux-out "$WORK/aux_data"

# 3'. synthetic reference-layout .pt store (stands in for the ERA5 download),
#     then the real ETL stage into the .npy store
python - "$WORK" <<'PY'
import os
import sys

import numpy as np
import torch

from pangu_tpu_torch.config import pangu_tiny
from pangu_tpu_torch.data.dataset import date_range, time_str

m = pangu_tiny().model
root = sys.argv[1] + "/era5_pt"
os.makedirs(root + "/upper", exist_ok=True)
os.makedirs(root + "/surface", exist_ok=True)
rng = np.random.default_rng(0)
for t in date_range("20180101 00:00:00", "20180103 12:00:00", "12h"):
    s = time_str(t)
    torch.save(torch.from_numpy(rng.standard_normal(
        (m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)),
        f"{root}/upper/upper_{s}.pt")
    torch.save(torch.from_numpy(rng.standard_normal(
        (m.surface_vars, m.lat, m.lon)).astype(np.float32)),
        f"{root}/surface/surface_{s}.pt")
print("synthetic .pt store written")
PY
python -m pangu_tpu_torch.scripts.convert_data --src "$WORK/era5_pt" --dst "$WORK/era5_npy" \
  --format pt --start "20180101 00:00:00" --end "20180103 12:00:00" \
  --freq 12h --workers 2

# 4. score (real stage: the reference test() protocol, tiny geometry)
python - "$WORK" "$DEVICE" <<'PY'
import sys

from pangu_tpu_torch.data.dataset import BATCH_READS
from pangu_tpu_torch.scripts import test

work, device = sys.argv[1:3]
test.main(["--preset", "tiny", "--weights", f"{work}/params_24.npz",
           "--aux-dir", f"{work}/aux_data",
           "--set", "data.store=npy", "--set", f"data.root={work}/era5_npy",
           "--set", "data.test_start=20180101 00:00:00",
           "--set", "data.test_end=20180103 00:00:00",
           "--set", "data.test_freq=12h",
           "--out", f"{work}/scores"], device=device)
print(f"scored on {device}; batches by reader {BATCH_READS}")
PY

# 5'. the verdict parse runs for real; the numbers are only checked for
#     finiteness (synthetic weights score garbage, by construction)
python - "$WORK/scores/test/24/csv" <<'PY'
import sys

import numpy as np

from pangu_tpu_torch.eval.csv_io import load_error_scores

csv = sys.argv[1]
# tiny geometry has its own level set: read the mid-level column of the same
# tables the real verdict reads
_, zcols, zvals = load_error_scores(csv, "rmse", "upper_z")
_, tcols, tvals = load_error_scores(csv, "rmse", "upper_t")
z = float(zvals[:, len(zcols) // 2].mean())
t = float(tvals[:, len(tcols) // 2].mean())
assert np.isfinite(z) and np.isfinite(t), (z, t)
print(f"dry-run OK: scoring pipeline wired (mid-level Z rmse={z:.3f}, "
      f"T rmse={t:.3f} on synthetic weights/data)")
PY
