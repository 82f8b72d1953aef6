"""Minimal ONNX protobuf wire-format reader/writer — zero dependencies.

The official Pangu-Weather weights ship as ONNX files; the reference needs
the ``onnx`` package to read them (models/onnx2torch.py:36-43). This module
decodes the subset of the ONNX ModelProto actually needed for weight import
(graph nodes, initializers, Constant-node tensors) straight from the
protobuf wire format, so conversion works on machines without onnx — and
encodes the same subset, which lets tests synthesize structurally-faithful
graphs (the export role of ``onnx.helper``).

Wire format reference: protobuf encoding spec (varints, length-delimited
fields). Field numbers from onnx.proto3:
  ModelProto:  ir_version=1, opset_import=8, graph=7
  GraphProto:  node=1, name=2, initializer=5, input=11, output=12
  NodeProto:   input=1, output=2, name=3, op_type=4, attribute=5
  AttributeProto: name=1, f=2, i=3, s=4, t=5, type=20
  TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
               int64_data=7, name=8, raw_data=9, double_data=10,
               external_data=13 (StringStringEntry key=1 value=2),
               data_location=14 (0=DEFAULT, 1=EXTERNAL)

Scale notes (the official weight files are ~1 GB ModelProtos; the reference
loads them whole with the onnx package, models/onnx2torch.py:36-43):

  * ``load_graph`` maps the file with ``mmap`` — no full-file RAM copy; the
    OS pages bytes in as the parse walks them.
  * Decoded tensors are ZERO-COPY read-only views into the mapped file
    (``np.frombuffer`` over the raw_data span); the mapping stays alive for
    as long as any returned array does. Callers that mutate must ``.copy()``.
  * Field/message lengths are plain varints all the way down, so raw_data
    blobs past 2**31 bytes decode like any other (protobuf's int32 size cap
    is a library choice the wire format itself does not have).
  * External-data tensors (``data_location=EXTERNAL``) resolve their
    ``location`` relative to the model file's directory, mmap'ed the same
    zero-copy way; absolute or directory-escaping locations are rejected.

The port's own copy of ``pangu_tpu/interop/onnx_wire.py`` (the port imports nothing of the
JAX package); tests/test_torch_port_modules.py holds it to the original.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype (the subset weight files use)
_DTYPES = {
    1: np.float32,   # FLOAT
    6: np.int32,     # INT32
    7: np.int64,     # INT64
    9: np.bool_,     # BOOL
    10: np.float16,  # FLOAT16
    11: np.float64,  # DOUBLE
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one message buffer.

    value is an int for varints/fixed, a memoryview for length-delimited.
    """
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wtype == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wtype == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:  # pragma: no cover - groups are long-dead protobuf
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _mmap_view(path: str) -> memoryview:
    """Read-only memoryview over a whole file via mmap (zero-copy; pages
    stream in on access). The mapping stays alive while any view — and any
    np.frombuffer array built over one — references it."""
    import mmap

    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return memoryview(b"")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return memoryview(mm)


def _load_external(ext: Dict[str, str], base_dir: Optional[str],
                   name: str) -> memoryview:
    """Raw bytes of an external-data tensor (data_location=EXTERNAL): mmap
    the ``location`` file relative to the model's directory and slice
    [offset, offset+length). Rejects absolute and directory-escaping
    locations (the ONNX spec requires a relative path)."""
    loc = ext.get("location", "")
    if not loc:
        raise ValueError(f"tensor {name!r}: external data without a location")
    if base_dir is None:
        raise ValueError(
            f"tensor {name!r} stores its data externally in {loc!r}; decode "
            f"via load_graph(path) so the model directory is known")
    base = os.path.abspath(base_dir)
    full = os.path.abspath(os.path.join(base, loc))
    if os.path.isabs(loc) or os.path.commonpath([base, full]) != base:
        raise ValueError(
            f"tensor {name!r}: external location {loc!r} escapes the model "
            f"directory")
    view = _mmap_view(full)
    offset = int(ext.get("offset", "0") or 0)
    length = int(ext.get("length", "0") or 0) or (len(view) - offset)
    if offset + length > len(view):
        raise ValueError(
            f"tensor {name!r}: external span [{offset}, {offset + length}) "
            f"exceeds {loc!r} ({len(view)} bytes)")
    return view[offset:offset + length]


def _decode_tensor(buf: memoryview,
                   base_dir: Optional[str] = None) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 1
    name = ""
    raw: Optional[memoryview] = None
    typed: Optional[np.ndarray] = None
    ext: Dict[str, str] = {}
    data_location = 0
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:  # dims (packed or unpacked varints)
            if wtype == 0:
                dims.append(val)
            else:
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    dims.append(d)
        elif fnum == 2:
            data_type = val
        elif fnum == 8:
            name = bytes(val).decode()
        elif fnum == 9:
            raw = val
        elif fnum == 4:  # float_data (packed)
            typed = np.frombuffer(bytes(val), dtype="<f4")
        elif fnum == 10:  # double_data
            typed = np.frombuffer(bytes(val), dtype="<f8")
        elif fnum in (5, 7):  # int32_data / int64_data (packed varints)
            vals = []
            p = 0
            while p < len(val):
                v, p = _read_varint(val, p)
                vals.append(v)
            typed = np.asarray(vals, dtype=np.int64 if fnum == 7 else np.int32)
        elif fnum == 13:  # external_data: StringStringEntry {key=1, value=2}
            k = v = None
            for efn, _, eval_ in _iter_fields(val):
                if efn == 1:
                    k = bytes(eval_).decode()
                elif efn == 2:
                    v = bytes(eval_).decode()
            if k is not None:
                ext[k] = v or ""
        elif fnum == 14:
            data_location = val
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {data_type}")
    if data_location == 1:  # EXTERNAL
        raw = _load_external(ext, base_dir, name)
    if raw is not None:
        # zero-copy read-only view into the mapped file (see module note)
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"))
    elif typed is not None:
        arr = typed.astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


@dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    # Constant-node payload / numeric attributes actually used by import
    tensor: Optional[np.ndarray] = None
    attrs: Dict[str, int] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]

    @property
    def constants(self) -> Dict[str, np.ndarray]:
        """Constant-node payloads by node name (reference
        models/onnx2torch.py:60-89 extracts aux data from these)."""
        return {
            n.name: n.tensor for n in self.nodes
            if n.op_type == "Constant" and n.tensor is not None
        }


def _decode_node(buf: memoryview,
                 base_dir: Optional[str] = None) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    tensor = None
    attrs: Dict[str, int] = {}
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            inputs.append(bytes(val).decode())
        elif fnum == 2:
            outputs.append(bytes(val).decode())
        elif fnum == 3:
            name = bytes(val).decode()
        elif fnum == 4:
            op_type = bytes(val).decode()
        elif fnum == 5:  # attribute
            aname, atensor, aint = "", None, None
            for afn, _, aval in _iter_fields(val):
                if afn == 1:
                    aname = bytes(aval).decode()
                elif afn == 5:
                    _, atensor = _decode_tensor(aval, base_dir)
                elif afn == 3:
                    aint = aval
            if aname == "value" and atensor is not None:
                tensor = atensor
            if aint is not None:
                attrs[aname] = aint
    return OnnxNode(op_type, name, tuple(inputs), tuple(outputs), tensor, attrs)


def load_graph(path: str) -> OnnxGraph:
    """Parse an .onnx file into nodes + initializers (+ Constant payloads).

    The file is mmap'ed, not read: tensors come back as zero-copy read-only
    views over the mapping (pages stream in on first touch), so a multi-GB
    weight file decodes without a full-size RAM copy. External-data tensors
    resolve relative to the file's directory."""
    base_dir = os.path.dirname(os.path.abspath(path))
    data = _mmap_view(path)
    graph_buf = None
    for fnum, _, val in _iter_fields(data):
        if fnum == 7:
            graph_buf = val
    if graph_buf is None:
        raise ValueError(f"{path}: no graph in ModelProto")
    nodes: List[OnnxNode] = []
    initializers: Dict[str, np.ndarray] = {}
    for fnum, _, val in _iter_fields(graph_buf):
        if fnum == 1:
            nodes.append(_decode_node(val, base_dir))
        elif fnum == 5:
            name, arr = _decode_tensor(val, base_dir)
            initializers[name] = arr
    return OnnxGraph(nodes, initializers)


# ---------------------------------------------------------------------------
# encoding (test/synthesis side)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wtype: int) -> bytes:
    return _varint((fnum << 3) | wtype)


def _len_field(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def _str_field(fnum: int, s: str) -> bytes:
    return _len_field(fnum, s.encode())


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    out = bytearray()
    for d in arr.shape:
        out += _tag(1, 0) + _varint(d)
    out += _tag(2, 0) + _varint(code)
    out += _str_field(8, name)
    out += _len_field(9, arr.astype(arr.dtype.newbyteorder("<"), copy=False)
                      .tobytes())
    return bytes(out)


def encode_external_tensor(name: str, shape: Tuple[int, ...], dtype,
                           location: str, offset: int = 0,
                           length: int = 0) -> bytes:
    """TensorProto with data_location=EXTERNAL: metadata only — the caller
    writes the raw little-endian payload into ``location`` itself (the layout
    onnx.external_data_helper produces for >2 GB weight files)."""
    code = _DTYPE_CODES.get(np.dtype(dtype))
    if code is None:
        raise ValueError(f"unsupported dtype {dtype}")
    out = bytearray()
    for d in shape:
        out += _tag(1, 0) + _varint(d)
    out += _tag(2, 0) + _varint(code)
    out += _str_field(8, name)
    entries = [("location", location)]
    if offset:
        entries.append(("offset", str(offset)))
    if length:
        entries.append(("length", str(length)))
    for k, v in entries:
        out += _len_field(13, _str_field(1, k) + _str_field(2, v))
    out += _tag(14, 0) + _varint(1)  # data_location = EXTERNAL
    return bytes(out)


def encode_node(op_type: str, inputs, outputs, name: str = "",
                tensor: Optional[np.ndarray] = None) -> bytes:
    out = bytearray()
    for i in inputs:
        out += _str_field(1, i)
    for o in outputs:
        out += _str_field(2, o)
    if name:
        out += _str_field(3, name)
    out += _str_field(4, op_type)
    if tensor is not None:
        attr = _str_field(1, "value") + _len_field(
            5, encode_tensor("", tensor)) + _tag(20, 0) + _varint(4)  # TENSOR
        out += _len_field(5, attr)
    return bytes(out)


def encode_model(nodes: List[bytes],
                 initializers: Dict[str, np.ndarray],
                 graph_name: str = "pangu") -> bytes:
    graph = bytearray()
    for n in nodes:
        graph += _len_field(1, n)
    graph += _str_field(2, graph_name)
    for name, arr in initializers.items():
        graph += _len_field(5, encode_tensor(name, arr))
    model = bytearray()
    model += _tag(1, 0) + _varint(8)  # ir_version
    model += _len_field(7, bytes(graph))
    return bytes(model)
