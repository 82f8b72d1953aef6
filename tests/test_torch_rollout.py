"""The port's forecast step and rollout against the JAX package, and the
port's independence from jax.

* f32 rollout: two steps of the port's ``rollout`` against JAX
  ``rollout_scan``, max|d| / max|ref| < 1e-4 (the golden guard's bound; both
  sides true f32).
* bf16 step: the port's flagship routing (bf16 compute, the block kernel --
  its plain version here, on the CPU) against the JAX f32 step. Measured on
  this tiny init, in normalized output units: max|d| 9.0e-4 (upper) and
  6.0e-4 (surface), RMS 1.5e-4 and 1.3e-4. The
  bound is the bf16 speed path's deviation measured at flagship geometry with
  real weights (docs/PARITY.md: max 0.026, RMS 0.005): the port's bf16 path
  must be no further from f32 than the JAX bf16 path is.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from pangu_tpu.aux import synthetic_aux_constants as jax_synthetic_aux
from pangu_tpu.config import pangu_tiny
from pangu_tpu.model import PanguModel as JaxPanguModel
from pangu_tpu.rollout.autoregressive import make_forecast_step as jax_forecast_step
from pangu_tpu.rollout.autoregressive import rollout_scan
from pangu_tpu_torch import config as port_config
from pangu_tpu_torch.aux import synthetic_aux_constants
from pangu_tpu_torch.interop.from_jax import init_params, load_jax_params
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.ops import fused_block_attention as tfba
from pangu_tpu_torch.rollout import make_forecast_step, rollout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pangu_tpu_torch")


@pytest.fixture(scope="module")
def setup():
    cfg = pangu_tiny()
    m = cfg.model
    jaux = jax_synthetic_aux(m, cfg.train)
    rng = np.random.default_rng(0)
    upper = rng.standard_normal((1, m.upper_vars, m.levels, m.lat, m.lon)).astype(np.float32)
    surface = rng.standard_normal((1, m.surface_vars, m.lat, m.lon)).astype(np.float32)
    jmodel = JaxPanguModel(m)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), upper, surface, jaux)
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = port_config.pangu_tiny()  # the port's own config, same preset
    return dict(cfg=cfg, m=m, tm=tcfg.model, jaux=jaux, jmodel=jmodel, params=params,
                aux=synthetic_aux_constants(tcfg.model, tcfg.train, device="cpu"),
                upper=upper, surface=surface)


def _port(setup, **model_kw):
    m = dataclasses.replace(setup["tm"], **model_kw)
    model = PanguModel(m)
    load_jax_params(model, m, setup["params"])
    return model


def _rel(got, ref) -> float:
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_two_step_rollout_matches_rollout_scan(setup):
    ref_u, ref_s = rollout_scan(setup["jmodel"], setup["params"], setup["upper"],
                                setup["surface"], setup["jaux"], 2)
    got_u, got_s = rollout(_port(setup), (torch.from_numpy(setup["upper"]),
                                          torch.from_numpy(setup["surface"])), setup["aux"], 2)
    assert got_u.shape[0] == 2 and got_s.shape[0] == 2
    assert _rel(got_u, ref_u) < 1e-4
    assert _rel(got_s, ref_s) < 1e-4


def test_rollout_without_trajectory_returns_the_last_step(setup):
    model = _port(setup)
    u, s = torch.from_numpy(setup["upper"]), torch.from_numpy(setup["surface"])
    traj_u, traj_s = rollout(model, (u, s), setup["aux"], 2)
    last_u, last_s = rollout(model, (u, s), setup["aux"], 2, keep_trajectory=False)
    torch.testing.assert_close(last_u, traj_u[-1], rtol=0, atol=0)
    torch.testing.assert_close(last_s, traj_s[-1], rtol=0, atol=0)


def test_bf16_step_against_jax_f32_step(setup):
    model = _port(setup, compute_dtype="bfloat16", use_pallas_attention=True)
    before = tfba.LAUNCHES
    got_u, got_s = make_forecast_step(model, setup["aux"])(
        torch.from_numpy(setup["upper"]), torch.from_numpy(setup["surface"]))
    assert tfba.LAUNCHES == before  # CPU tensors: the plain version, never the kernel
    ref_u, ref_s = jax_forecast_step(setup["jmodel"], donate=False)(
        setup["params"], setup["upper"], setup["surface"], setup["jaux"])
    aux = setup["jaux"]
    for got, ref, std in ((got_u, ref_u, aux.upper_std), (got_s, ref_s, aux.surface_std)):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        d = (got.numpy() - np.asarray(ref)) / std  # normalized output units
        assert np.abs(d).max() < 0.026
        assert np.sqrt(np.mean(d ** 2)) < 0.005


def test_init_params_is_seeded(setup):
    m = setup["tm"]
    a, b, c = PanguModel(m), PanguModel(m), PanguModel(m)
    init_params(a, seed=1)
    init_params(b, seed=1)
    init_params(c, seed=2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    key = "layers.EarthSpecificLayer0.blocks.EarthSpecificBlock0.attention.linear1.weight"
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa[key], sc[key])
    assert float(sa[key].abs().max()) <= 0.04 and float(sa[key].std()) > 0.01
    ln = "layers.EarthSpecificLayer0.blocks.EarthSpecificBlock0.norm1"
    assert torch.equal(sa[ln + ".weight"], torch.ones_like(sa[ln + ".weight"]))
    assert torch.equal(sa[ln + ".bias"], torch.zeros_like(sa[ln + ".bias"]))


def _port_modules():
    return sorted("pangu_tpu_torch" + (("." + rel[:-3].replace(os.sep, "."))
                                       .replace(".__init__", "") if rel != "__init__.py" else "")
                  for d, _, files in os.walk(PORT) for f in files if f.endswith(".py")
                  for rel in [os.path.relpath(os.path.join(d, f), PORT)])


#: the forecast-and-score path: weight import, scores, data, engines and scripts
FORECAST_AND_SCORE = [
    "pangu_tpu_torch.cli", "pangu_tpu_torch.data", "pangu_tpu_torch.data.dataset",
    "pangu_tpu_torch.eval", "pangu_tpu_torch.eval.csv_io", "pangu_tpu_torch.eval.evaluate",
    "pangu_tpu_torch.eval.visualize", "pangu_tpu_torch.interop.npz_io",
    "pangu_tpu_torch.interop.onnx_import", "pangu_tpu_torch.interop.onnx_wire",
    "pangu_tpu_torch.metrics", "pangu_tpu_torch.model.fuxi", "pangu_tpu_torch.rollout.aggregate",
    "pangu_tpu_torch.rollout.engines", "pangu_tpu_torch.scripts.convert_weights",
    "pangu_tpu_torch.scripts.rollout", "pangu_tpu_torch.scripts.test",
    "pangu_tpu_torch.utils.logger",
]


#: the finetuning path: summary, checkpoints, the Trainer, LoRA, data parallelism, the
#: pipeline and their scripts
FINETUNE = [
    "pangu_tpu_torch.utils.summary", "pangu_tpu_torch.train.checkpoint",
    "pangu_tpu_torch.train.trainer", "pangu_tpu_torch.train.lora",
    "pangu_tpu_torch.interop.from_jax", "pangu_tpu_torch.scripts.finetune",
    "pangu_tpu_torch.scripts.lora_tune", "pangu_tpu_torch.parallel",
    "pangu_tpu_torch.parallel.mesh", "pangu_tpu_torch.parallel.sharding",
    "pangu_tpu_torch.parallel.pipeline", "pangu_tpu_torch.scripts.pipeline_train",
    "pangu_tpu_torch.scripts.bench_pipeline",
]


#: the serving path: the exported step, the profiling tools, the export and bound
#: scripts, and the demo (which imports matplotlib only where it renders)
SERVING = [
    "pangu_tpu_torch.serving", "pangu_tpu_torch.utils.profiling",
    "pangu_tpu_torch.scripts.export_model", "pangu_tpu_torch.scripts.parity_bf16_bound",
    "pangu_tpu_torch.demo", "pangu_tpu_torch.demo.app",
]


#: the data layer: the native batch reader, statistics, the ETL and their scripts
DATA = [
    "pangu_tpu_torch.data.native_loader", "pangu_tpu_torch.data.stats",
    "pangu_tpu_torch.data.convert", "pangu_tpu_torch.scripts.convert_data",
    "pangu_tpu_torch.scripts.stats",
]


def test_importing_the_port_does_not_import_jax():
    """A fresh process that imports every module of the port (the
    forecast-and-score, finetuning, serving and data modules and scripts
    among them) holds no jax, jaxlib or flax and no module of the JAX
    package."""
    assert set(FORECAST_AND_SCORE + FINETUNE + SERVING + DATA) <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pangu_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def _python_sources():
    out = [os.path.relpath(os.path.join(d, f), REPO)
           for d, _, files in os.walk(PORT) for f in files if f.endswith(".py")]
    return sorted(out) + [os.path.join("tests", f) for f in (
        "test_torch_gpu.py", "torch_card.py",
        *(f"torch_{name}_worker.py" for name in ("parallel", "spatial", "pipeline")))]


@pytest.mark.parametrize("path", _python_sources())
def test_no_port_source_imports_jax(path):
    """Source level: no import of jax, jaxlib, flax or any module of the JAX
    package (the port keeps its own copies of the jax-free ones), in the
    port, the on-card tests and what they share with the rank workers
    (they run where jax is absent), and the rank workers of the
    data-parallel, spatial and pipeline tests."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "pangu_tpu"), (path, name)


def test_the_data_layer_and_its_scripts_import_no_pandas():
    """The data modules and their scripts import in a process
    where pandas cannot be imported (the ETL's timestamps come from the
    port's ``date_range``), and pull in no module of pandas, jax or the JAX
    package."""
    code = (
        "import importlib, sys\n"
        "sys.modules['pandas'] = None\n"
        f"for name in {DATA!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.split('.')[0] in ('pandas', 'jax', 'flax', 'pangu_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_evaluate_and_rollout_run_without_pandas_or_matplotlib(tmp_path):
    """The test script (evaluate) and a multi-day rollout at tiny geometry
    in a process where pandas and matplotlib cannot be imported: the card's
    machine has neither, and nothing the on-card tests run may need them."""
    out = str(tmp_path)
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import math, os\n"
        "from pangu_tpu_torch.scripts import rollout, test\n"
        "argv = ['--preset', 'tiny', '--out', %r, '--set', 'data.test_start=20180101',\n"
        "        '--set', 'data.test_end=20180104', '--set', 'data.prefetch=0']\n"
        "assert math.isfinite(test.main(argv, device='cpu'))\n"
        "d = rollout.main(argv + ['--mode', 'multi', '--lead-days', '1'], device='cpu')\n"
        "assert len(os.listdir(os.path.join(d, '2018010100', 'csv'))) == 14\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.split('.')[0] in ('pandas', 'matplotlib', 'jax', 'pangu_tpu'))\n"
        "assert not bad, bad\n" % out
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300)
    assert len(os.listdir(os.path.join(out, "test", "24", "csv"))) == 14
