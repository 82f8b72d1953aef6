"""The port's own copies of the JAX package's jax-free modules against the
originals: ``pangu_tpu_torch.config``, ``geometry``, ``utils.flops`` and
``interop.torch_import`` must give what ``pangu_tpu``'s give (the port
imports nothing of the JAX package, so it keeps copies; these tests keep them
in step). Exact equality throughout: the modules are pure Python and numpy.
"""

import dataclasses

import numpy as np
import pytest

from pangu_tpu import config as jcfg
from pangu_tpu import geometry as jgeo
from pangu_tpu.interop import torch_import as jti
from pangu_tpu.utils import flops as jflops
from pangu_tpu_torch import config as tcfg
from pangu_tpu_torch import geometry as tgeo
from pangu_tpu_torch.interop import torch_import as tti
from pangu_tpu_torch.model import PanguModel
from pangu_tpu_torch.utils import flops as tflops

CLASSES = ("ModelConfig", "DataConfig", "TrainConfig", "EvalConfig", "ParallelConfig",
           "PanguConfig")
PRESETS = {"tiny": ("pangu_tiny", {}), "flagship": ("pangu_pretrain", {"horizon": 24}),
           "flagship_bf16": ("pangu_pretrain", dict(horizon=6, compute_dtype="bfloat16",
                                                     use_pallas_attention=True))}


def _defaults(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return dataclasses.MISSING


@pytest.mark.parametrize("name", CLASSES)
def test_config_dataclasses_have_the_same_fields_and_defaults(name):
    ref, got = dataclasses.fields(getattr(jcfg, name)), dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in got] == [f.name for f in ref]
    for a, b in zip(got, ref):
        da, db = _defaults(a), _defaults(b)
        if dataclasses.is_dataclass(db):
            da, db = dataclasses.asdict(da), dataclasses.asdict(db)
        assert da == db, (name, a.name)


def _pair(preset):
    fn, kw = PRESETS[preset]
    return getattr(jcfg, fn)(**kw), getattr(tcfg, fn)(**kw)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_and_overrides_match(preset):
    ref, got = _pair(preset)
    assert tcfg.to_dict(got) == jcfg.to_dict(ref)
    over = ["model.dims=[32,64,64,32]", "train.lr=0.001", "model.remat=false"]
    assert tcfg.to_dict(tcfg.apply_overrides(got, over)) == jcfg.to_dict(
        jcfg.apply_overrides(ref, over))


@pytest.mark.parametrize("preset", ["tiny", "flagship"])
def test_compute_geometry_matches(preset):
    ref, got = _pair(preset)
    assert dataclasses.asdict(tgeo.compute_geometry(got.model)) == dataclasses.asdict(
        jgeo.compute_geometry(ref.model))


@pytest.mark.parametrize("preset", ["tiny", "flagship"])
def test_flop_counts_match(preset):
    ref, got = _pair(preset)
    for batch in (1, 2):
        assert tflops.forward_matmul_flops(got.model, batch) == jflops.forward_matmul_flops(
            ref.model, batch)
        assert tflops.train_matmul_flops(got.model, batch) == jflops.train_matmul_flops(
            ref.model, batch)


@pytest.mark.parametrize("preset", ["tiny", "flagship"])
def test_reference_key_map_matches(preset):
    ref, got = _pair(preset)
    r, g = jti.reference_key_map(ref.model), tti.reference_key_map(got.model)
    assert [(k, p, f.__name__) for k, p, f in g] == [(k, p, f.__name__) for k, p, f in r]


def test_state_dict_round_trip_matches():
    """A seeded reference state dict -> the JAX param tree (the original's
    ``params_from_state_dict``) -> a state dict through each copy."""
    ref, got = _pair("tiny")
    rng = np.random.default_rng(3)

    state = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in PanguModel(got.model).state_dict().items()}
    params = jti.params_from_state_dict(ref.model, state)
    a = tti.state_dict_from_params(got.model, params)
    b = jti.state_dict_from_params(ref.model, params)
    assert sorted(a) == sorted(b) == sorted(state)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a[k], state[k], err_msg=k)
