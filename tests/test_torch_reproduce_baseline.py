"""The port's ``reproduce_baseline.sh --dry-run`` (``pangu_tpu_torch/scripts/``)
and its synthetic ONNX writer.

* ``build_synthetic_onnx`` is the port's copy of
  ``tests/test_onnx_import.py::build_synthetic_onnx`` over the port's
  ``geometry`` and ``interop.onnx_wire``: the dry run imports it, and neither
  may import jax or the JAX package, so this module imports the JAX package
  only inside its tests. For the same rng both functions write the same
  ONNX bytes.
* The dry run through the real shell script in a subprocess with its own
  time limit (the way tests/test_scripts_cli.py runs the JAX one): synthetic
  ONNX -> convert_weights -> a .pt store -> convert_data -> the test script
  (on the CPU, asked for with ``PANGU_DEVICE=cpu``) -> the verdict parse.
  Its score CSVs against the JAX package's test script on the same weights
  file, aux files and npy store: RMSE at rtol 1e-4, ACC at atol 1e-4 (the
  golden guard's f32 bound).
* Without ``--dry-run`` the script refuses to run.
"""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

from pangu_tpu_torch.geometry import compute_geometry
from pangu_tpu_torch.interop import onnx_wire as wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join("pangu_tpu_torch", "scripts", "reproduce_baseline.sh")


def build_synthetic_onnx(cfg, rng, path, fused_ln: bool = False):
    """Emit a graph with the official export's structure on tiny geometry.

    ``fused_ln`` switches LayerNorms between the Mul+Add decomposition and
    single LayerNormalization nodes (both appear in the wild; the matcher
    must handle either). Returns {onnx_name: array} ground truth and the
    {torch_name: onnx_name} map the derivation must reproduce.
    """
    geo = compute_geometry(cfg)
    t = geo.outer.tokens_per_window
    inits = {}
    nodes = []
    truth_map = {}
    tid = itertools.count(1000)
    aid = itertools.count(1)  # readable b1.aN module counter
    cur = ["input"]

    def tname():
        return f"t{next(tid)}"

    def add_init(name, shape):
        inits[name] = rng.standard_normal(shape).astype(np.float32)
        return name

    def conv(torch_w, torch_b, out_ch, in_ch):
        a = next(aid)
        w = add_init(f"b1.a{a}.weight", (out_ch, in_ch, 1))
        b = add_init(f"b1.a{a}.bias", (out_ch,))
        o = tname()
        nodes.append(wire.encode_node("Conv", [cur[0], w, b], [o]))
        cur[0] = o
        truth_map[torch_w] = w
        truth_map[torch_b] = b

    def matmul(torch_w, shape):
        w = add_init(f"onnx::MatMul_{next(tid)}", shape)
        o = tname()
        nodes.append(wire.encode_node("MatMul", [cur[0], w], [o]))
        cur[0] = o
        truth_map[torch_w] = w

    def bias_add(torch_b, shape, readable):
        b = add_init(readable, shape)
        o = tname()
        nodes.append(wire.encode_node("Add", [cur[0], b], [o]))
        cur[0] = o
        truth_map[torch_b] = b

    def tensor_add(torch_b, shape):
        b = add_init(f"onnx::Add_{next(tid)}", shape)
        o = tname()
        nodes.append(wire.encode_node("Add", [cur[0], b], [o]))
        cur[0] = o
        truth_map[torch_b] = b

    def layer_norm(torch_prefix, dim):
        a = next(aid)
        s = add_init(f"b1.a{a}.weight", (dim,))
        b = add_init(f"b1.a{a}.bias", (dim,))
        if fused_ln:
            o = tname()
            nodes.append(wire.encode_node("LayerNormalization",
                                          [cur[0], s, b], [o]))
            cur[0] = o
        else:
            o1, o2 = tname(), tname()
            nodes.append(wire.encode_node("Mul", [cur[0], s], [o1]))
            nodes.append(wire.encode_node("Add", [o1, b], [o2]))
            cur[0] = o2
        truth_map[torch_prefix + ".weight"] = s
        truth_map[torch_prefix + ".bias"] = b

    def block(i, j, shifted):
        ref = f"layers.EarthSpecificLayer{i}.blocks.EarthSpecificBlock{j}."
        c = cfg.dims[i]
        heads = cfg.heads[i]
        nt = (geo.outer if i in (0, 3) else geo.inner).n_type_windows
        a = next(aid)
        matmul(ref + "attention.linear1.weight", (c, 3 * c))
        bias_add(ref + "attention.linear1.bias", (3 * c,), f"b1.a{a}.bias")
        tensor_add(ref + "attention.earth_specific_bias",
                   (1, nt, heads, t, t))
        if shifted:
            # shift mask arrives via a Constant node, NOT an initializer —
            # the matcher must not confuse it with the earth bias
            m = tname()
            nodes.append(wire.encode_node(
                "Constant", [], [m], name=f"/b1/mask_{i}_{j}",
                tensor=np.zeros((nt, t, t), np.float32)))
            o = tname()
            nodes.append(wire.encode_node("Add", [cur[0], m], [o]))
            cur[0] = o
        o = tname()
        nodes.append(wire.encode_node("Softmax", [cur[0]], [o]))
        cur[0] = o
        a = next(aid)
        matmul(ref + "attention.linear2.weight", (c, c))
        bias_add(ref + "attention.linear2.bias", (c,), f"b1.a{a}.bias")
        layer_norm(ref + "norm1", c)
        a = next(aid)
        matmul(ref + "linear.linear1.weight", (c, cfg.mlp_ratio * c))
        bias_add(ref + "linear.linear1.bias", (cfg.mlp_ratio * c,),
                 f"b1.a{a}.fc1.bias")
        o = tname()
        nodes.append(wire.encode_node("Erf", [cur[0]], [o]))
        cur[0] = o
        matmul(ref + "linear.linear2.weight", (cfg.mlp_ratio * c, c))
        bias_add(ref + "linear.linear2.bias", (c,), f"b1.a{a}.fc2.bias")
        layer_norm(ref + "norm2", c)

    # normalization statistics / masks as named Constant nodes
    # (reference models/onnx2torch.py:60-89). The surface masks live on the
    # PATCH-PADDED grid like the official export's 724 x 1440 (= 721 + 3);
    # the upper constant channel is unpadded like the real Constant_17.
    for cname, shape in [("/b1/Constant_9", (cfg.upper_vars, 1, 1, 1)),
                         ("/b1/Constant_10", (cfg.upper_vars, 1, 1, 1)),
                         ("/b1/Constant_11", (cfg.surface_vars, 1, 1)),
                         ("/b1/Constant_12", (cfg.surface_vars, 1, 1)),
                         ("/b1/Constant_44",
                          (3, cfg.lat + geo.lat_pad, cfg.lon)),
                         ("/b1/Constant_17", (1, cfg.levels, cfg.lat, cfg.lon))]:
        o = tname()
        nodes.append(wire.encode_node(
            "Constant", [], [o], name=cname,
            tensor=rng.standard_normal(shape).astype(np.float32)))

    conv("_input_layer.conv.weight", "_input_layer.conv.bias",
         cfg.dims[0], cfg.embed_upper_channels)
    conv("_input_layer.conv_surface.weight", "_input_layer.conv_surface.bias",
         cfg.dims[0], cfg.embed_surface_channels)
    for j in range(cfg.depths[0]):
        block(0, j, bool(j % 2))
    layer_norm("downsample.norm", 4 * cfg.dims[0])
    matmul("downsample.linear.weight", (4 * cfg.dims[0], cfg.dims[1]))
    for i in (1, 2):
        for j in range(cfg.depths[i]):
            block(i, j, bool(j % 2))
    matmul("upsample.linear1.weight", (cfg.dims[2], 4 * cfg.dims[3]))
    layer_norm("upsample.norm", cfg.dims[3])
    matmul("upsample.linear2.weight", (cfg.dims[3], cfg.dims[3]))
    for j in range(cfg.depths[3]):
        block(3, j, bool(j % 2))
    cin = cfg.dims[3] + cfg.dims[0]
    conv("_output_layer.conv.weight", "_output_layer.conv.bias",
         cfg.recovery_upper_channels, cin)
    conv("_output_layer.conv_surface.weight", "_output_layer.conv_surface.bias",
         cfg.recovery_surface_channels, cin)

    with open(path, "wb") as f:
        f.write(wire.encode_model(nodes, inits))
    return inits, truth_map


@pytest.mark.parametrize("fused_ln", [False, True])
def test_copy_writes_the_originals_onnx_bytes(tmp_path, fused_ln):
    from pangu_tpu.config import pangu_tiny as jax_tiny
    from pangu_tpu_torch.config import pangu_tiny
    from test_onnx_import import build_synthetic_onnx as original

    got = build_synthetic_onnx(pangu_tiny().model, np.random.default_rng(3),
                               str(tmp_path / "port.onnx"), fused_ln=fused_ln)
    ref = original(jax_tiny().model, np.random.default_rng(3), str(tmp_path / "jax.onnx"),
                   fused_ln=fused_ln)
    assert (tmp_path / "port.onnx").read_bytes() == (tmp_path / "jax.onnx").read_bytes()
    assert got[1] == ref[1] and sorted(got[0]) == sorted(ref[0])
    for k in ref[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k], err_msg=k)


def _run(args, timeout):
    # the script scores on the card by default; this host has none
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PANGU_DEVICE"] = "cpu"
    return subprocess.run(["bash", SCRIPT, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_dry_run_scores_like_the_jax_test_script(tmp_path, monkeypatch):
    from test_torch_eval import _jax_script, assert_same_csv_tree
    from test_torch_native_loader import build_locked

    build_locked()
    work = tmp_path / "work"
    res = _run(["--dry-run", str(work)], timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "dry-run OK" in res.stdout
    # the two test samples, a batch each, both through the native reader
    assert "scored on cpu; batches by reader {'native': 2, 'per_sample': 0}" in res.stdout
    assert sorted(os.listdir(work / "era5_npy" / "upper")) == [
        f"upper_201801{d:02d}{h:02d}.npy" for d in (1, 2, 3) for h in (0, 12)]

    monkeypatch.setattr(sys, "argv", [
        "test.py", "--preset", "tiny", "--weights", str(work / "params_24.npz"),
        "--aux-dir", str(work / "aux_data"), "--set", "data.store=npy",
        "--set", f"data.root={work / 'era5_npy'}",
        "--set", "data.test_start=20180101 00:00:00",
        "--set", "data.test_end=20180103 00:00:00", "--set", "data.test_freq=12h",
        "--out", str(tmp_path / "jax")])
    _jax_script("test").main()
    assert assert_same_csv_tree(str(work / "scores" / "test"),
                                str(tmp_path / "jax" / "test")) == 14


def test_without_dry_run_the_script_refuses():
    res = _run([], timeout=60)
    assert res.returncode != 0
    assert "published weights and ERA5" in res.stderr
