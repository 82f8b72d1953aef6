"""The port's bf16 bound script (``pangu_tpu_torch/scripts/parity_bf16_bound.py``,
the twin of ``scripts/parity_bf16_bound.py``) at tiny geometry on the CPU:
the JAX script's JSON keys, finite values, and a deviation of the bf16
route from the f32 path inside the flagship bound of docs/PARITY.md (max
0.026, RMS 0.005 in normalized units). The flagship reading needs the card
(``python -m pangu_tpu_torch.scripts.parity_bf16_bound`` there).
"""

import importlib.util
import json
import math
import os

from pangu_tpu_torch.scripts import parity_bf16_bound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_bf16_bound", os.path.join(REPO, "scripts", "parity_bf16_bound.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else type(v).__name__ for k, v in d.items()}


def test_tiny_bound_has_the_jax_keys_and_stays_in_bounds():
    got = parity_bf16_bound.run(tiny=True, device="cpu")
    ref = _jax_script().run(tiny=True)
    assert _keys(got) == _keys(ref)
    assert (got["geometry"], got["backend"], got["pallas"]) == ("tiny", "cpu", True)
    for out in ("upper", "surface"):
        g, r = got[out], ref[out]
        assert len(g["per_var_rms"]) == len(r["per_var_rms"])
        values = [g["max_abs"], g["mean_abs"], g["rms"], g["rel_rms"], *g["per_var_rms"]]
        assert all(math.isfinite(v) and v >= 0 for v in values)
        assert g["max_abs"] < 0.026 and g["rms"] < 0.005 and g["rms"] > 0


def test_main_prints_one_json_line(capsys):
    out = parity_bf16_bound.main(["--tiny"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out and out["device_kind"] == "cpu"
