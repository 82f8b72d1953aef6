"""The port's own copies of the JAX package's jax-free modules against the
originals: ``pangu_tpu_torch.config``, ``geometry``, ``utils.flops`` and
``interop.torch_import`` must give what ``pangu_tpu``'s give, and the verbatim
copies (``utils.logger``, ``interop.npz_io``, ``interop.onnx_wire``,
``interop.onnx_import``, ``rollout.aggregate``, ``eval.visualize``) must hold
the original's code (the port imports nothing of the JAX package, so it keeps
copies; these tests keep them in step). Exact equality throughout: the modules
are pure Python and numpy.
"""

import ast
import dataclasses
import os

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


#: the port's verbatim copies of jax-free modules: (port module, original module)
COPIES = {
    "utils/logger.py": "utils/logger.py",
    "interop/npz_io.py": "interop/npz_io.py",
    "interop/onnx_wire.py": "interop/onnx_wire.py",
    "interop/onnx_import.py": "interop/onnx_import.py",
    "rollout/aggregate.py": "rollout/aggregate.py",
    "eval/visualize.py": "eval/visualize.py",
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _code_of(path: str, package: str) -> str:
    """The module's syntax tree without its module docstring, with imports
    of ``package`` renamed to ``pangu_tpu``: what a copy must keep."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        tree.body = body[1:]
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == package or node.module.startswith(package + ".")):
            node.module = "pangu_tpu" + node.module[len(package):]
    return ast.dump(tree)


@pytest.mark.parametrize("port, original", sorted(COPIES.items()))
def test_copied_module_is_its_original(port, original):
    """A copy is a copy: the same code as the original but for its module
    docstring and its imports, which point at the port's own modules."""
    got = _code_of(os.path.join(REPO, "pangu_tpu_torch", port), "pangu_tpu_torch")
    ref = _code_of(os.path.join(REPO, "pangu_tpu", original), "pangu_tpu")
    assert got == ref, port


def test_logger_copy_writes_the_same_lines(tmp_path):
    from pangu_tpu.utils.logger import get_logger as jax_logger
    from pangu_tpu_torch.utils.logger import get_logger

    a = get_logger("port_logger_copy", str(tmp_path / "a" / "run.log"))
    b = jax_logger("jax_logger_copy", str(tmp_path / "b" / "run.log"))
    assert get_logger("port_logger_copy") is a
    for logger in (a, b):
        logger.info("step %d", 3)
        for h in logger.handlers:
            h.flush()
    la = (tmp_path / "a" / "run.log").read_text().split(" : ")[-1]
    lb = (tmp_path / "b" / "run.log").read_text().split(" : ")[-1]
    assert la == lb == "step 3\n"


@pytest.mark.parametrize("argv", [
    [],
    ["--preset", "tiny", "--horizon", "6", "--out", "runs/x", "--set", "train.lr=0.001"],
    ["--horizon", "3", "--set", "model.compute_dtype=bfloat16",
     "--set", "model.use_pallas_attention=true", "--set", "data.test_start=20240101"],
])
def test_cli_parser_and_config_match(argv):
    """The port's ``cli`` twin: the same flags and defaults, the same config
    from the same command line (the JAX package's compile cache aside)."""
    from pangu_tpu import cli as jcli
    from pangu_tpu_torch import cli as tcli

    ref_parser, got_parser = jcli.base_parser("x"), tcli.base_parser("x")
    assert [(a.dest, a.option_strings, a.default, a.choices) for a in got_parser._actions] == [
        (a.dest, a.option_strings, a.default, a.choices) for a in ref_parser._actions]
    ref = jcli.build_config(ref_parser.parse_args(argv))
    got = tcli.build_config(got_parser.parse_args(argv))
    assert tcfg.to_dict(got) == jcfg.to_dict(ref)
