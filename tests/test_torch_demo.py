"""The port's demo (``pangu_tpu_torch/demo/app.py``, the twin of
``demo/app.py``), headless, on the CPU.

* The tiny preset's forecast frames against the JAX demo's on the same
  seeded weights (the config's seed) and synthetic store: max|d| / max|ref|
  < 1e-4 (the golden guard's bound; both sides true f32).
* The static HTML report: one panel per surface variable and step; with
  ``--weights`` (a JAX-written ``.npz``) through the shared CLI loader.

The report needs matplotlib, which the card's machine lacks: those tests
skip where it is missing.
"""

import argparse
import os
import sys
from datetime import datetime

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(**kw):
    base = dict(config=None, preset="tiny", horizon=24, overrides=[], out=None, weights=None,
                aux_dir=None, steps=2, init="2024010100")
    return argparse.Namespace(**{**base, **kw})


def test_demo_forecast_matches_the_jax_demo(tmp_path):
    from pangu_tpu.aux import synthetic_aux_constants
    from pangu_tpu.config import pangu_tiny
    from pangu_tpu.interop.npz_io import save_params_npz
    from pangu_tpu.model import PanguModel
    from pangu_tpu_torch.demo import app

    sys.path.insert(0, REPO)
    try:
        from demo import app as jax_app
    finally:
        sys.path.remove(REPO)
    cfg = pangu_tiny()
    m = cfg.model
    u = np.zeros((1, m.upper_vars, m.levels, m.lat, m.lon), np.float32)
    s = np.zeros((1, m.surface_vars, m.lat, m.lon), np.float32)
    params = PanguModel(m).init(jax.random.PRNGKey(5), u, s,
                                synthetic_aux_constants(m, cfg.train))
    ckpt = str(tmp_path / "tiny.npz")
    save_params_npz(ckpt, params)
    init = datetime(2024, 1, 1)
    _, ref = jax_app._forecast(init, 2, _args(weights=ckpt))
    cfg, got = app._forecast(init, 2, _args(weights=ckpt), "cpu")
    assert cfg.model.surface_vars == m.surface_vars and len(got) == len(ref) == 2
    for (gu, gs), (ru, rs) in zip(got, ref):
        for g, r in ((gu, np.asarray(ru)), (gs, np.asarray(rs))):
            assert g.shape == r.shape
            assert np.abs(g - r).max() / np.abs(r).max() < 1e-4


def test_demo_headless_report(tmp_path):
    pytest.importorskip("matplotlib")
    from pangu_tpu_torch.demo import app

    out = tmp_path / "rep"
    path = app.main(["--steps", "1", "--out", str(out)], device="cpu")
    assert path == str(out / "index.html")
    html = (out / "index.html").read_text()
    assert html.count("<img") == 4  # one panel per surface variable


def test_demo_headless_real_weights(tmp_path):
    """--weights routes through cli.load_model_and_params (npz branch)."""
    pytest.importorskip("matplotlib")
    from pangu_tpu_torch.config import pangu_tiny
    from pangu_tpu_torch.demo import app
    from pangu_tpu_torch.interop.from_jax import init_params, save_params_npz
    from pangu_tpu_torch.model import PanguModel

    model = PanguModel(pangu_tiny().model)
    init_params(model, seed=3)
    ckpt = tmp_path / "tiny.npz"
    save_params_npz(str(ckpt), model)
    out = tmp_path / "rep_w"
    app.main(["--steps", "2", "--weights", str(ckpt), "--out", str(out)], device="cpu")
    assert (out / "index.html").read_text().count("<img") == 8


def test_demo_refuses_unknown_flags_headless():
    from pangu_tpu_torch.demo import app

    with pytest.raises(SystemExit):
        app.main(["--no-such-flag"], device="cpu")
