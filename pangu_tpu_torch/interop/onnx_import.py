"""Import the official Pangu-Weather ONNX weights (reference models/
onnx2torch.py:1-167) directly into a pangu_tpu param tree + aux constants.

The official graphs store:
  * initializers — the learnable weights, named like ``b1.a1.weight`` or
    ``onnx::MatMul_8952`` (graph-assigned ids). The id-based names carry no
    structure, so the map torch_name -> onnx_name is **derived from the
    graph** (`derive_name_map`): initializers are classified by their first
    consuming node (Conv / MatMul / Add / LayerNormalization decomposition)
    and aligned in execution order against the model's known parameter
    sequence, shape-checked at every step. A user CSV in the keys_all.csv
    format the reference ships remains accepted as an override.
  * Constant nodes — normalization statistics and constant masks, extracted
    by node name (reference models/onnx2torch.py:60-89):
      /b1/Constant_9..12  -> upper_mean/upper_std/surface_mean/surface_std
      /b1/Constant_44     -> constantMask{h} (3 surface masks, padded grid)
      /b1/Constant_17     -> const_h (constant upper channel)

Layout notes: ONNX MatMul weights are (in, out) — our Dense layout — so
linear kernels import without transposition (the reference transposes them
into torch's (out, in) and we would transpose back). Conv1d kernels are
(out, in, 1) and the dense earth bias is (1, nT, heads, T, T).

The port's own copy of ``pangu_tpu/interop/onnx_import.py`` (the port imports nothing of the
JAX package); tests/test_torch_port_modules.py holds it to the original;
its imports point at the port's ``config``, ``geometry`` and ``interop``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.geometry import compute_geometry
from pangu_tpu_torch.interop.torch_import import _t_bias_squeeze, _t_conv1d, _t_linear, reference_key_map

# Constant-node name -> aux file stem (reference models/onnx2torch.py:60-89)
DEFAULT_CONSTANT_MAP = {
    "/b1/Constant_9": "upper_mean",
    "/b1/Constant_10": "upper_std",
    "/b1/Constant_11": "surface_mean",
    "/b1/Constant_12": "surface_std",
    "/b1/Constant_44": "constantMask",
    "/b1/Constant_17": "Constant_17_output_0",
}


def load_name_map(csv_path: str) -> Dict[str, str]:
    """torch_name -> onnx_name pairs (keys_all.csv format)."""
    out: Dict[str, str] = {}
    with open(csv_path) as f:
        for row in csv.reader(f):
            if len(row) != 2 or row[0] == "torch_name":
                continue
            out[row[0].strip()] = row[1].strip()
    return out


def _expected_stream(cfg: ModelConfig) -> List:
    """The model's parameter tensors in graph execution order, as match items.

    Items:
      ("conv_group", [(weight_key, bias_key, weight_shape), ...]) — Conv
          units matched by weight shape within the group (the embed and
          recovery convs are definition-order-ambiguous but shape-distinct);
      ("mm", torch_key, shape)     — a MatMul weight;
      ("vec", torch_key, shape)    — any 1-D tensor (bias / LN scale or
          bias; decomposed LayerNorm consumes scale via Mul then bias via
          Add, same order as a fused LayerNormalization's inputs);
      ("tensor", torch_key, shape) — the dense earth bias added to scores.

    Execution order follows the official forward (reproduced by reference
    models/pangu_model.py:61-104): embed convs; per block qkv -> qkv bias ->
    earth bias -> proj -> proj bias -> norm1 -> fc1 -> fc2 -> norm2 (the
    post-norm residual order, models/layers.py:296-297); downsample norm ->
    reduction; upsample expand -> norm -> mix; recovery convs. Verified
    against the monotone onnx::MatMul_N ids in the reference keys_all.csv.
    """
    geo = compute_geometry(cfg)
    c0 = cfg.dims[0]
    t = geo.outer.tokens_per_window
    stream: List = [
        ("conv_group", [
            ("_input_layer.conv.weight", "_input_layer.conv.bias",
             (c0, cfg.embed_upper_channels, 1)),
            ("_input_layer.conv_surface.weight",
             "_input_layer.conv_surface.bias",
             (c0, cfg.embed_surface_channels, 1)),
        ]),
    ]

    def block(i: int, j: int) -> List:
        ref = f"layers.EarthSpecificLayer{i}.blocks.EarthSpecificBlock{j}."
        c = cfg.dims[i]
        heads = cfg.heads[i]
        nt = (geo.outer if i in (0, 3) else geo.inner).n_type_windows
        return [
            ("mm", ref + "attention.linear1.weight", (c, 3 * c)),
            ("vec", ref + "attention.linear1.bias", (3 * c,)),
            ("tensor", ref + "attention.earth_specific_bias",
             (1, nt, heads, t, t)),
            ("mm", ref + "attention.linear2.weight", (c, c)),
            ("vec", ref + "attention.linear2.bias", (c,)),
            ("vec", ref + "norm1.weight", (c,)),
            ("vec", ref + "norm1.bias", (c,)),
            ("mm", ref + "linear.linear1.weight", (c, cfg.mlp_ratio * c)),
            ("vec", ref + "linear.linear1.bias", (cfg.mlp_ratio * c,)),
            ("mm", ref + "linear.linear2.weight", (cfg.mlp_ratio * c, c)),
            ("vec", ref + "linear.linear2.bias", (c,)),
            ("vec", ref + "norm2.weight", (c,)),
            ("vec", ref + "norm2.bias", (c,)),
        ]

    for j in range(cfg.depths[0]):
        stream += block(0, j)
    stream += [
        ("vec", "downsample.norm.weight", (4 * c0,)),
        ("vec", "downsample.norm.bias", (4 * c0,)),
        ("mm", "downsample.linear.weight", (4 * c0, cfg.dims[1])),
    ]
    for i in (1, 2):
        for j in range(cfg.depths[i]):
            stream += block(i, j)
    stream += [
        ("mm", "upsample.linear1.weight", (cfg.dims[2], 4 * cfg.dims[3])),
        ("vec", "upsample.norm.weight", (cfg.dims[3],)),
        ("vec", "upsample.norm.bias", (cfg.dims[3],)),
        ("mm", "upsample.linear2.weight", (cfg.dims[3], cfg.dims[3])),
    ]
    for j in range(cfg.depths[3]):
        stream += block(3, j)
    cin = cfg.dims[3] + cfg.dims[0]  # skip concat (models/pangu_model.py:98)
    stream.append(("conv_group", [
        ("_output_layer.conv.weight", "_output_layer.conv.bias",
         (cfg.recovery_upper_channels, cin, 1)),
        ("_output_layer.conv_surface.weight", "_output_layer.conv_surface.bias",
         (cfg.recovery_surface_channels, cin, 1)),
    ]))
    return stream


def _observed_stream(nodes: Sequence, shapes: Mapping[str, Tuple[int, ...]]) -> List:
    """Classify each initializer by its first consuming node, in node order.

    Items mirror `_expected_stream`: ("conv", wname, bname, wshape),
    ("mm", name, shape), ("vec", name, shape), ("tensor", name, shape).
    """
    seen: set = set()
    out: List = []

    def fresh(name: str) -> bool:
        if name in shapes and name not in seen:
            seen.add(name)
            return True
        return False

    for node in nodes:
        op = node.op_type
        ins = node.inputs
        if op == "Conv" and len(ins) >= 2 and fresh(ins[1]):
            bias = ins[2] if len(ins) > 2 and fresh(ins[2]) else None
            out.append(("conv", ins[1], bias, shapes[ins[1]]))
        elif op in ("MatMul", "Gemm"):
            if op == "Gemm" and node.attrs.get("transB"):
                raise ValueError(
                    f"node {node.name}: Gemm transB=1 layout is not supported"
                )
            for x in ins[1:2] if op == "Gemm" else ins:
                if fresh(x):
                    out.append(("mm", x, shapes[x]))
            if op == "Gemm" and len(ins) > 2 and fresh(ins[2]):
                out.append(("vec", ins[2], shapes[ins[2]]))
        elif op == "LayerNormalization":
            for x in ins[1:3]:
                if fresh(x):
                    out.append(("vec", x, shapes[x]))
        elif op in ("Add", "Sub", "Mul", "Div"):
            for x in ins:
                if fresh(x):
                    kind = "vec" if len(shapes[x]) == 1 else "tensor"
                    out.append((kind, x, shapes[x]))
    return out


def derive_name_map(
    cfg: ModelConfig,
    nodes: Sequence,
    initializer_shapes: Mapping[str, Tuple[int, ...]],
) -> Dict[str, str]:
    """Derive {torch_name: onnx_name} structurally — no CSV needed.

    Subsequence alignment: walk the observed units in node order, consuming
    the expected units in execution order whenever kind+shape match exactly;
    unrelated initializers (masks, statistics folded as initializers) are
    skipped. Raises with a precise location if the walk cannot complete.
    """
    expected = _expected_stream(cfg)
    observed = _observed_stream(nodes, {
        k: tuple(v) for k, v in initializer_shapes.items()
    })
    mapping: Dict[str, str] = {}
    e = 0
    pending_group: List = []

    def try_group(obs) -> bool:
        if obs[0] != "conv":
            return False
        for idx, (wkey, bkey, wshape) in enumerate(pending_group):
            if obs[3] == wshape:
                mapping[wkey] = obs[1]
                if obs[2] is not None:
                    mapping[bkey] = obs[2]
                del pending_group[idx]
                return True
        return False

    for obs in observed:
        if e >= len(expected) and not pending_group:
            break
        if pending_group and try_group(obs):
            continue
        if e >= len(expected):
            continue
        item = expected[e]
        if item[0] == "conv_group":
            # enter the group, then try this very unit against it
            if not pending_group:
                shapes_in_group = [u[2] for u in item[1]]
                if len(set(shapes_in_group)) != len(shapes_in_group):
                    raise ValueError(
                        "embed/recovery conv weight shapes are identical at "
                        "this geometry; structural matching is ambiguous — "
                        "provide a name-map CSV"
                    )
                pending_group.extend(item[1])
                e += 1
            if try_group(obs):
                continue
        elif obs[0] == item[0] and obs[-1] == item[2]:
            mapping[item[1]] = obs[1]
            e += 1
            continue
        # else: unrelated initializer — skip it

    if pending_group or e < len(expected):
        missing = ([u[0] for u in pending_group]
                   + [i[1] if i[0] != "conv_group" else i[1][0][0]
                      for i in expected[e:]])
        raise ValueError(
            f"could not locate {len(missing)} parameters in the ONNX graph "
            f"(first missing: {missing[0]}); the graph structure does not "
            f"match this model geometry — check horizon/config or supply a "
            f"name-map CSV"
        )
    return mapping


def params_from_onnx_weights(
    cfg: ModelConfig,
    onnx_weights: Mapping[str, np.ndarray],
    name_map: Mapping[str, str],
    strict: bool = True,
) -> Dict:
    """Build {'params': ...} from an {onnx_name: array} dict."""
    tree: Dict = {}
    missing = []
    for torch_key, path, tr in reference_key_map(cfg):
        onnx_name = name_map.get(torch_key)
        if onnx_name is None or onnx_name not in onnx_weights:
            missing.append(torch_key)
            continue
        w = np.asarray(onnx_weights[onnx_name], dtype=np.float32)
        # our Dense layout == ONNX MatMul layout: linear kernels pass through
        if tr is _t_linear:
            value = np.ascontiguousarray(w)
        elif tr is _t_conv1d:
            value = np.ascontiguousarray(w[:, :, 0].T)
        elif tr is _t_bias_squeeze:
            # earth bias stored (1, nT, heads, T, T) or already squeezed
            value = np.asarray(w)[0] if w.ndim == 5 else np.asarray(w)
        else:
            value = np.asarray(w)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    if strict and missing:
        raise KeyError(
            f"{len(missing)} weights missing from the ONNX graph / name map, "
            f"e.g. {missing[:5]}"
        )
    return {"params": tree}


def read_onnx(path: str):
    """(initializers, constant-node outputs, node list) from an ONNX file.

    Uses the onnx package when installed; otherwise falls back to the
    built-in wire-format decoder (interop/onnx_wire.py) — conversion has no
    hard dependency on onnx.
    """
    try:
        import onnx
        from onnx import numpy_helper
    except ImportError:
        from pangu_tpu_torch.interop.onnx_wire import load_graph

        g = load_graph(path)
        return g.initializers, g.constants, g.nodes

    from pangu_tpu_torch.interop.onnx_wire import OnnxNode

    graph = onnx.load(path).graph
    weights = {i.name: numpy_helper.to_array(i) for i in graph.initializer}
    constants: Dict[str, np.ndarray] = {}
    nodes = []
    for node in graph.node:
        attrs = {a.name: a.i for a in node.attribute if a.type == 2}  # INT
        nodes.append(OnnxNode(node.op_type, node.name, tuple(node.input),
                              tuple(node.output), None, attrs))
        if node.op_type != "Constant":
            continue
        for attr in node.attribute:
            if attr.name == "value":
                constants[node.name] = numpy_helper.to_array(attr.t)
    return weights, constants, nodes


def extract_aux_files(
    constants: Mapping[str, np.ndarray],
    out_dir: str,
    horizon: int,
    constant_map: Optional[Mapping[str, str]] = None,
) -> Dict[str, str]:
    """Write the aux .npy files (reference models/onnx2torch.py:60-89)."""
    constant_map = dict(constant_map or DEFAULT_CONSTANT_MAP)
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for node_name, stem in constant_map.items():
        if node_name not in constants:
            continue
        name = f"constantMask{horizon}" if stem == "constantMask" else stem
        path = os.path.join(out_dir, f"{name}.npy")
        np.save(path, np.asarray(constants[node_name], dtype=np.float32))
        written[name] = path
    return written


def convert_onnx_checkpoint(
    cfg: ModelConfig,
    onnx_path: str,
    name_map_csv: Optional[str] = None,
    out_params_npz: str = "pangu_params.npz",
    aux_out_dir: Optional[str] = None,
    horizon: int = 24,
    name_map_out: Optional[str] = None,
) -> None:
    """Full conversion: .onnx -> params .npz + aux .npy files.

    Without ``name_map_csv`` the torch->onnx name map is derived from the
    graph structure (works out of the box on the official weights, the role
    the reference delegates to its hand-made keys_all.csv); with it, the CSV
    is authoritative. ``name_map_out`` dumps the derived map for inspection.
    """
    from pangu_tpu_torch.interop.npz_io import save_params_npz

    weights, constants, nodes = read_onnx(onnx_path)
    if name_map_csv:
        name_map = load_name_map(name_map_csv)
    else:
        name_map = derive_name_map(
            cfg, nodes, {k: v.shape for k, v in weights.items()}
        )
    if name_map_out:
        with open(name_map_out, "w") as f:
            f.write("torch_name,onnx_name\n")
            for k, v in name_map.items():
                f.write(f"{k},{v}\n")
    params = params_from_onnx_weights(cfg, weights, name_map)
    save_params_npz(out_params_npz, params)
    if aux_out_dir:
        extract_aux_files(constants, aux_out_dir, horizon)
