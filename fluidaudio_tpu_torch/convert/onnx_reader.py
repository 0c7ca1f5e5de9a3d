"""Minimal ONNX weight reader — raw protobuf wire-format, no `onnx` package.

The upstream Supertonic-3 release ships ONNX graphs only
(the reference's `Sources/FluidAudio/TTS/Supertonic3/Supertonic3Constants.swift:9-13`);
the project depends on no `onnx`/`onnxruntime`, so the converter extracts
initializers (weights) by decoding the protobuf wire format directly.
Covers exactly what weight extraction needs:

  ModelProto.graph (field 7) -> GraphProto
  GraphProto.initializer (field 5, repeated TensorProto)
  GraphProto.node (field 1, repeated NodeProto — summarized only)
  TensorProto: dims(1), data_type(2), float_data(4), int64_data(7),
               name(8), raw_data(9)

Unsupported pieces (segmented/external data) raise with a clear message.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# ONNX TensorProto.DataType values
_DTYPES = {
    1: np.float32,   # FLOAT
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


class OnnxParseError(ValueError):
    pass


def _signed64(v: int) -> int:
    """Protobuf varints carry int64 as two's complement in uint64 space."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise OnnxParseError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise OnnxParseError("varint too long")


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value_or_view) for one message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:  # 64-bit
            yield field, wire, bytes(buf[pos : pos + 8])
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field, wire, bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise OnnxParseError(f"unsupported wire type {wire}")


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw: bytes | None = None
    float_data: list[float] = []
    int64_data: list[int] = []
    int32_data: list[int] = []
    external = False
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 1 and wire == 2:  # packed dims
            p = 0
            mv = val
            while p < len(mv):
                v, p = _read_varint(mv, p)
                dims.append(v)
        elif field == 2 and wire == 0:
            dtype_code = val
        elif field == 4 and wire == 2:  # packed float_data
            float_data.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
        elif field == 4 and wire == 5:
            float_data.append(struct.unpack("<f", val)[0])
        elif field == 7 and wire == 2:  # packed int64_data
            p = 0
            mv = val
            while p < len(mv):
                v, p = _read_varint(mv, p)
                int64_data.append(_signed64(v))
        elif field == 7 and wire == 0:
            int64_data.append(_signed64(val))
        elif field == 5 and wire == 2:  # packed int32_data (also f16/u8 store)
            p = 0
            mv = val
            while p < len(mv):
                v, p = _read_varint(mv, p)
                int32_data.append(_signed64(v))
        elif field == 5 and wire == 0:
            int32_data.append(_signed64(val))
        elif field == 3 and wire == 2:  # segment
            raise OnnxParseError(f"tensor {name!r} uses segments (unsupported)")
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 13:  # external_data
            external = True
    if external:
        raise OnnxParseError(f"tensor {name!r} uses external data (unsupported)")
    np_dtype = _DTYPES.get(dtype_code)
    if np_dtype is None:
        raise OnnxParseError(f"tensor {name!r}: unsupported dtype code {dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        # int32_data also stores f16/u8/bool payloads (ONNX packs them here
        # when raw_data is absent): materialize via int32 then view-cast
        if np_dtype == np.float16:
            arr = np.asarray(int32_data, np.uint16).view(np.float16)
        else:
            arr = np.asarray(int32_data, np.int64).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    try:
        arr = arr.reshape(dims) if dims else arr
    except ValueError as e:
        raise OnnxParseError(f"tensor {name!r}: shape {dims} vs {arr.size} values") from e
    return name, arr


def _parse_node_summary(buf: memoryview) -> str:
    op_type = ""
    for field, wire, val in _iter_fields(buf):
        if field == 4 and wire == 2:
            op_type = bytes(val).decode("utf-8", "replace")
    return op_type


class OnnxNode:
    """NodeProto subset: op_type + I/O names + int/float attributes."""

    __slots__ = ("op_type", "name", "inputs", "outputs", "attrs")

    def __init__(self):
        self.op_type = ""
        self.name = ""
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        self.attrs: dict[str, object] = {}

    def __repr__(self):
        return f"OnnxNode({self.op_type}, in={self.inputs}, out={self.outputs})"


def _parse_attribute(buf: memoryview) -> tuple[str, object]:
    """AttributeProto: name(1), f(2), i(3), s(4), floats(7), ints(8)."""
    name = ""
    value: object = None
    ints: list[int] = []
    floats: list[float] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 2 and wire == 5:
            value = struct.unpack("<f", val)[0]
        elif field == 3 and wire == 0:
            value = _signed64(val)
        elif field == 4 and wire == 2:
            value = bytes(val)
        elif field == 8 and wire == 0:
            ints.append(_signed64(val))
        elif field == 8 and wire == 2:
            p = 0
            while p < len(val):
                v, p = _read_varint(val, p)
                ints.append(_signed64(v))
        elif field == 7 and wire == 5:
            floats.append(struct.unpack("<f", val)[0])
    if ints:
        value = ints
    elif floats:
        value = floats
    return name, value


def _parse_node(buf: memoryview) -> OnnxNode:
    node = OnnxNode()
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            node.inputs.append(bytes(val).decode("utf-8", "replace"))
        elif field == 2 and wire == 2:
            node.outputs.append(bytes(val).decode("utf-8", "replace"))
        elif field == 3 and wire == 2:
            node.name = bytes(val).decode("utf-8", "replace")
        elif field == 4 and wire == 2:
            node.op_type = bytes(val).decode("utf-8", "replace")
        elif field == 5 and wire == 2:
            k, v = _parse_attribute(val)
            if k:
                node.attrs[k] = v
    return node


class OnnxGraph:
    """Weights + full node list (graph-order, which ONNX requires to be
    topologically sorted) — the connectivity view the topology-based
    Supertonic3 converter matches against (`convert/supertonic3.py`)."""

    def __init__(self, weights: dict[str, np.ndarray], nodes: list[OnnxNode]):
        self.weights = weights
        self.nodes = nodes

    def weight_events(self):
        """Yield (node, input_position, name, shape) for every node input
        that is an initializer, in graph/input order — the op-position
        stream name-free matching keys on."""
        for node in self.nodes:
            for pos, inp in enumerate(node.inputs):
                if inp in self.weights:
                    yield node, pos, inp, self.weights[inp].shape


def read_onnx_graph(path: str | Path) -> OnnxGraph:
    """Full-connectivity read: initializers + ordered nodes with I/O names."""
    data = memoryview(Path(path).read_bytes())
    graph: memoryview | None = None
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == 2:
            graph = val
            break
    if graph is None:
        raise OnnxParseError("no GraphProto (field 7) found — not an ONNX model?")
    weights: dict[str, np.ndarray] = {}
    nodes: list[OnnxNode] = []
    for field, wire, val in _iter_fields(graph):
        if field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            weights[name] = arr
        elif field == 1 and wire == 2:
            nodes.append(_parse_node(val))
    return OnnxGraph(weights, nodes)


def read_onnx(path: str | Path) -> tuple[dict[str, np.ndarray], dict[str, int]]:
    """-> (initializers {name: array}, node op_type histogram)."""
    data = memoryview(Path(path).read_bytes())
    graph: memoryview | None = None
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == 2:
            graph = val
            break
    if graph is None:
        raise OnnxParseError("no GraphProto (field 7) found — not an ONNX model?")
    weights: dict[str, np.ndarray] = {}
    ops: dict[str, int] = {}
    for field, wire, val in _iter_fields(graph):
        if field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            weights[name] = arr
        elif field == 1 and wire == 2:
            op = _parse_node_summary(val)
            ops[op] = ops.get(op, 0) + 1
    return weights, ops


def read_onnx_initializers(path: str | Path) -> dict[str, np.ndarray]:
    return read_onnx(path)[0]
