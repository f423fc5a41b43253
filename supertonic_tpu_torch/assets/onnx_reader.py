"""Dependency-free ONNX graph reader (and minimal writer, for tests).

The reference ships its networks as four ONNX graphs (SURVEY.md §2.2); this
environment has neither the assets nor the ``onnx``/``onnxruntime`` packages,
so weight extraction is implemented directly against the protobuf wire
format. Field numbers follow onnx.proto3 (onnx/onnx.proto in the upstream
ONNX repo):

    ModelProto:   ir_version=1, producer_name=2, graph=7, opset_import=8
    GraphProto:   node=1, name=2, initializer=5, input=11, output=12
    NodeProto:    input=1, output=2, name=3, op_type=4, attribute=5, domain=7
    AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20
    TensorProto:  dims=1, data_type=2, float_data=4, int32_data=5,
                  int64_data=7, name=8, raw_data=9, double_data=10
    ValueInfoProto: name=1, type=2; TypeProto.tensor_type=1;
    TensorTypeProto: elem_type=1, shape=2; TensorShapeProto.dim=1;
    Dimension: dim_value=1, dim_param=2
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Iterator

import numpy as np

# ONNX TensorProto.DataType
DTYPE_MAP = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}
try:  # bfloat16 (TensorProto type 16) via ml_dtypes, where installed
    import ml_dtypes

    DTYPE_MAP[16] = ml_dtypes.bfloat16
except ImportError:  # pragma: no cover
    pass
DTYPE_REV = {np.dtype(v): k for k, v in DTYPE_MAP.items()}


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def iter_fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yields (field_number, wire_type, value). wire types: 0 varint,
    1 fixed64, 2 length-delimited(bytes), 5 fixed32."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _packed_varints(buf: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zigzag_to_signed(v: int, bits: int = 64) -> int:
    # ONNX int64 fields are plain (not zigzag); two's-complement from varint
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


# ---------------------------------------------------------------------------
# message decoders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OnnxTensor:
    name: str
    dims: tuple[int, ...]
    dtype: Any
    data: np.ndarray
    # TensorProto.external_data entries ({location, offset, length, ...});
    # non-None until resolved against the model's directory — accessing
    # ``data`` before that would silently yield zeros, so parse_model /
    # load_onnx resolve or raise.
    external: dict[str, str] | None = None


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any]


@dataclasses.dataclass
class OnnxValueInfo:
    name: str
    elem_type: int | None
    shape: tuple[Any, ...]  # ints or str dim_params


@dataclasses.dataclass
class OnnxGraph:
    name: str
    nodes: list[OnnxNode]
    initializers: dict[str, OnnxTensor]
    inputs: list[OnnxValueInfo]
    outputs: list[OnnxValueInfo]
    # ai.onnx opset version from ModelProto.opset_import (None on bare
    # subgraphs); version-sensitive op semantics (e.g. Softmax < 13)
    # consult this
    opset: int | None = None


def parse_tensor(buf: bytes) -> OnnxTensor:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = None
    float_data: list[float] = []
    int_data: list[int] = []
    uint_data: list[int] = []
    double_data: list[float] = []
    external: dict[str, str] = {}
    for field, wt, val in iter_fields(buf):
        if field == 1:
            if wt == 0:
                dims.append(_zigzag_to_signed(val))
            else:
                dims.extend(_zigzag_to_signed(v) for v in _packed_varints(val))
        elif field == 2:
            data_type = val
        elif field == 4:
            if wt == 2:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", val)
                )
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif field == 5:
            # int32_data carries int32/int16/int8/uint8/uint16/bool/float16;
            # negative values arrive as 64-bit two's-complement varints and
            # must be sign-extended before the narrowing astype below.
            if wt == 2:
                int_data.extend(
                    _zigzag_to_signed(v) for v in _packed_varints(val)
                )
            else:
                int_data.append(_zigzag_to_signed(val))
        elif field == 7:
            if wt == 2:
                int_data.extend(
                    _zigzag_to_signed(v) for v in _packed_varints(val)
                )
            else:
                int_data.append(_zigzag_to_signed(val))
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = bytes(val)
        elif field == 13:  # external_data: StringStringEntryProto k/v pairs
            k = v = ""
            for f2, _w2, v2 in iter_fields(val):
                if f2 == 1:
                    k = v2.decode()
                elif f2 == 2:
                    v = v2.decode()
            external[k] = v
        elif field == 10:
            if wt == 2:
                double_data.extend(struct.unpack(f"<{len(val) // 8}d", val))
            else:
                double_data.append(struct.unpack("<d", val)[0])
        elif field == 11:  # uint64_data (uint32/uint64 typed form): plain
            # unsigned varints, NO sign extension
            if wt == 2:
                uint_data.extend(_packed_varints(val))
            else:
                uint_data.append(val)
    np_dtype = DTYPE_MAP.get(data_type)
    if np_dtype is None:
        # decoding unknown element types as f32 would silently corrupt
        # weights (e.g. float8 variants); fail loudly instead
        raise ValueError(
            f"tensor {name!r}: unsupported TensorProto data_type "
            f"{data_type}")
    shape = tuple(dims)
    if external:
        return OnnxTensor(name, shape, np_dtype,
                          np.zeros(shape, np_dtype), external)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    elif float_data:
        arr = np.array(float_data, np.float32).reshape(shape)
    elif double_data:
        arr = np.array(double_data, np.float64).reshape(shape)
    elif int_data:
        if np.dtype(np_dtype).itemsize == 2 and data_type in (10, 16):
            # float16/bfloat16 typed data is stored bitwise in int32_data
            arr = np.array(int_data, np.uint16).view(np_dtype).reshape(shape)
        else:
            arr = np.array(int_data, np.int64).astype(np_dtype).reshape(shape)
    elif uint_data:
        arr = np.array(uint_data, np.uint64).astype(np_dtype).reshape(shape)
    else:
        arr = np.zeros(shape, np_dtype)
    return OnnxTensor(name, shape, np_dtype, arr)


def _parse_attribute(buf: bytes) -> tuple[str, Any]:
    name = ""
    value: Any = None
    atype = 0
    ints: list[int] = []
    floats: list[float] = []
    strings: list[str] = []
    for field, wt, val in iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 20:  # AttributeProto.type
            atype = val
        elif field == 2:
            value = struct.unpack("<f", val)[0]
        elif field == 3:
            value = _zigzag_to_signed(val)
        elif field == 4:
            value = val.decode(errors="replace")
        elif field == 5:
            value = parse_tensor(val)
        elif field == 6:  # g: subgraph (If/Loop/Scan bodies)
            value = parse_graph(val)
        elif field == 7:
            if wt == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:
            if wt == 2:
                ints.extend(_zigzag_to_signed(v) for v in _packed_varints(val))
            else:
                ints.append(_zigzag_to_signed(val))
        elif field == 9:  # strings (repeated bytes): e.g. RNN 'activations'
            strings.append(val.decode(errors="replace"))
    if ints:
        value = ints
    elif floats:
        value = floats
    elif strings:
        value = strings
    if value is None:
        # proto3 omits zero-valued scalar fields on the wire: a present
        # attribute with type INT and no i field IS axis=0 (ubiquitous in
        # real exports, e.g. Gather(axis=0) embedding lookups). The in-repo
        # writer emits zero fields explicitly, so only real ONNX files hit
        # this. Repeated types (FLOATS/INTS/STRINGS) deliberately stay None:
        # ONNX Reduce* treats an absent-or-empty `axes` as reduce-ALL-dims,
        # so resolving an explicitly-typed empty INTS to [] would turn that
        # into a no-op reduce — each op's default handles None correctly.
        value = {1: 0.0, 2: 0, 3: ""}.get(atype)
    return name, value


def _parse_node(buf: bytes) -> OnnxNode:
    inputs, outputs, attrs = [], [], {}
    op_type = name = ""
    for field, _wt, val in iter_fields(buf):
        if field == 1:
            inputs.append(val.decode())
        elif field == 2:
            outputs.append(val.decode())
        elif field == 3:
            name = val.decode()
        elif field == 4:
            op_type = val.decode()
        elif field == 5:
            k, v = _parse_attribute(val)
            attrs[k] = v
    return OnnxNode(op_type, name, inputs, outputs, attrs)


def _parse_value_info(buf: bytes) -> OnnxValueInfo:
    name = ""
    elem_type = None
    shape: tuple[Any, ...] = ()
    for field, _wt, val in iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:  # TypeProto
            for f2, _w2, v2 in iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in iter_fields(v2):
                        if f3 == 1:
                            elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            dims: list[Any] = []
                            for f4, _w4, v4 in iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim: Any = None
                                    for f5, _w5, v5 in iter_fields(v4):
                                        if f5 == 1:
                                            dim = _zigzag_to_signed(v5)
                                        elif f5 == 2:
                                            dim = v5.decode()
                                    dims.append(dim)
                            shape = tuple(dims)
    return OnnxValueInfo(name, elem_type, shape)


def parse_graph(buf: bytes) -> OnnxGraph:
    nodes: list[OnnxNode] = []
    inits: dict[str, OnnxTensor] = {}
    inputs: list[OnnxValueInfo] = []
    outputs: list[OnnxValueInfo] = []
    name = ""
    for field, _wt, val in iter_fields(buf):
        if field == 1:
            nodes.append(_parse_node(val))
        elif field == 2:
            name = val.decode()
        elif field == 5:
            t = parse_tensor(val)
            inits[t.name] = t
        elif field == 11:
            inputs.append(_parse_value_info(val))
        elif field == 12:
            outputs.append(_parse_value_info(val))
    return OnnxGraph(name, nodes, inits, inputs, outputs)


def _walk_graphs(g: OnnxGraph) -> Iterator[OnnxGraph]:
    yield g
    for node in g.nodes:
        for v in node.attrs.values():
            if isinstance(v, OnnxGraph):
                yield from _walk_graphs(v)


def _all_tensors(g: OnnxGraph) -> Iterator[OnnxTensor]:
    """Every tensor in the model: initializers AND node-attribute tensors
    (Constant 'value', ConstantOfShape 'value', ...) across all subgraphs —
    onnx.external_data_helper can externalize attribute tensors too."""
    for sub in _walk_graphs(g):
        yield from sub.initializers.values()
        for node in sub.nodes:
            for v in node.attrs.values():
                if isinstance(v, OnnxTensor):
                    yield v


def _resolve_external(g: OnnxGraph, base_dir: str | None) -> None:
    """Load externally-stored tensor payloads (TensorProto.external_data)
    from files next to the model. Raises instead of silently serving the
    zero placeholders parse_tensor leaves behind."""
    import os

    pending = [t for t in _all_tensors(g) if t.external]
    if not pending:
        return
    if base_dir is None:
        raise ValueError(
            "model stores tensor data in external files "
            f"({', '.join(sorted(t.name for t in pending)[:5])}…) — parse it "
            "with parse_model(data, base_dir=...) or load_onnx(path) so the "
            "sidecar files can be located"
        )
    for t in pending:
        loc = t.external.get("location", "")
        path = os.path.normpath(os.path.join(base_dir, loc))
        if not loc or os.path.isabs(loc) or not path.startswith(
                os.path.normpath(base_dir) + os.sep):
            raise ValueError(
                f"tensor {t.name!r}: unsafe external data location {loc!r}")
        offset = int(t.external.get("offset", 0) or 0)
        length = t.external.get("length")
        n_bytes = int(np.prod(t.dims, dtype=np.int64)) * np.dtype(t.dtype).itemsize
        if length is not None and int(length) != n_bytes:
            raise ValueError(
                f"tensor {t.name!r}: external length {length} != "
                f"expected {n_bytes} bytes for {t.dims} {np.dtype(t.dtype)}")
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(n_bytes)
        if len(raw) != n_bytes:
            raise ValueError(
                f"tensor {t.name!r}: external file {path} too short "
                f"({len(raw)} < {n_bytes} bytes at offset {offset})")
        t.data = np.frombuffer(raw, dtype=t.dtype).reshape(t.dims)
        t.external = None


def parse_model(data: bytes, base_dir: str | None = None) -> OnnxGraph:
    """Parse a serialized ModelProto, returning its graph. ``base_dir``
    locates external-data sidecar files (required if the model uses any)."""
    g = None
    opset = None
    for field, _wt, val in iter_fields(data):
        if field == 7:
            g = parse_graph(val)
        elif field == 8:  # OperatorSetIdProto: domain=1, version=2
            domain, version = "", None
            for f2, _w2, v2 in iter_fields(val):
                if f2 == 1:
                    domain = v2.decode()
                elif f2 == 2:
                    version = v2
            if domain in ("", "ai.onnx") and version is not None:
                opset = int(version)
    if g is None:
        raise ValueError("no graph found in model")
    g.opset = opset
    _resolve_external(g, base_dir)
    return g


def load_onnx(path: str) -> OnnxGraph:
    import os

    with open(path, "rb") as f:
        return parse_model(f.read(), base_dir=os.path.dirname(
            os.path.abspath(path)))


# ---------------------------------------------------------------------------
# minimal writer (round-trip tests + fixture generation)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    # NB: np.ascontiguousarray would promote 0-d scalars to 1-d
    arr = np.asarray(arr, order="C")
    out = b""
    for d in arr.shape:
        out += _tag(1, 0) + _varint(d)
    out += _tag(2, 0) + _varint(DTYPE_REV[arr.dtype])
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())
    return out


def encode_node(op_type: str, inputs: list[str], outputs: list[str],
                name: str = "", attrs: dict | None = None) -> bytes:
    out = b""
    for i in inputs:
        out += _ld(1, i.encode())
    for o in outputs:
        out += _ld(2, o.encode())
    out += _ld(3, name.encode())
    out += _ld(4, op_type.encode())
    for k, v in (attrs or {}).items():
        a = _ld(1, k.encode())
        if isinstance(v, float):
            a += _tag(2, 5) + struct.pack("<f", v)
        elif isinstance(v, bool):
            a += _tag(3, 0) + _varint(int(v))
        elif isinstance(v, int):
            a += _tag(3, 0) + _varint(v)
        elif isinstance(v, str):
            a += _ld(4, v.encode())
        elif isinstance(v, np.ndarray):
            a += _ld(5, encode_tensor("", v))
        elif isinstance(v, SubgraphAttr):
            a += _ld(6, v.payload)
        elif isinstance(v, (list, tuple)) and all(isinstance(x, int) for x in v):
            for x in v:
                a += _tag(8, 0) + _varint(x)
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, float) for x in v):
            for x in v:
                a += _tag(7, 5) + struct.pack("<f", x)
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, str) for x in v):
            for x in v:  # strings (field 9): e.g. RNN 'activations'
                a += _ld(9, x.encode())
        else:
            raise TypeError(f"unsupported attribute value for '{k}': {v!r}")
        out += _ld(5, a)
    return out


def encode_value_info(name: str, dtype, shape: tuple) -> bytes:
    """ValueInfoProto for graph inputs/outputs. ``shape`` entries may be ints
    or strings (symbolic dim_params)."""
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dim = _ld(2, d.encode())
        else:
            dim = _tag(1, 0) + _varint(int(d))
        dims += _ld(1, dim)
    tensor_type = _tag(1, 0) + _varint(DTYPE_REV[np.dtype(dtype)])
    tensor_type += _ld(2, dims)
    type_proto = _ld(1, tensor_type)
    return _ld(1, name.encode()) + _ld(2, type_proto)


class SubgraphAttr:
    """Wrap encoded GraphProto bytes for use as a node attribute
    (If/Loop/Scan bodies)."""

    def __init__(self, payload: bytes):
        self.payload = payload


def encode_graph(graph_name: str, nodes: list[bytes],
                 initializers: list[bytes],
                 inputs: list[bytes] | None = None,
                 outputs: list[bytes] | None = None) -> bytes:
    g = _ld(2, graph_name.encode())
    for n in nodes:
        g += _ld(1, n)
    for t in initializers:
        g += _ld(5, t)
    for vi in inputs or []:
        g += _ld(11, vi)
    for vi in outputs or []:
        g += _ld(12, vi)
    return g


def encode_model(graph_name: str, nodes: list[bytes],
                 initializers: list[bytes],
                 inputs: list[bytes] | None = None,
                 outputs: list[bytes] | None = None,
                 opset: int = 17) -> bytes:
    model = _tag(1, 0) + _varint(8)  # ir_version
    model += _ld(7, encode_graph(graph_name, nodes, initializers,
                                 inputs, outputs))
    model += _ld(8, _tag(2, 0) + _varint(opset))  # opset_import.version
    return model
