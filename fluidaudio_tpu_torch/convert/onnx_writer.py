"""Minimal ONNX writer — raw protobuf wire format, no `onnx` package.

Counterpart of `convert/onnx_reader.py`, used to author synthetic ONNX
fixtures offline (this image has no `onnx`/`onnxruntime`): the Supertonic3
topology converter is pinned against graphs written here with OPAQUE tensor
names, proving conversion keys on graph structure + shapes, never names
(reference ships ONNX-only releases, `Supertonic3Constants.swift:9-13`).

Writes exactly the subset the reader consumes: ModelProto.graph(7) with
node(1), initializer(5); TensorProto dims(1)/data_type(2)/name(8)/raw_data(9);
NodeProto input(1)/output(2)/name(3)/op_type(4)/attribute(5) with int/ints
attributes.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_NP_TO_ONNX = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
}


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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _varint_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    code = _NP_TO_ONNX.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype} for tensor {name!r}")
    out = bytearray()
    for d in arr.shape:
        out += _varint_field(1, d)
    out += _varint_field(2, code)
    out += _len_field(8, name.encode())
    out += _len_field(9, arr.tobytes())
    return bytes(out)


def encode_attribute(name: str, value) -> bytes:
    out = bytearray(_len_field(1, name.encode()))
    if isinstance(value, bool):
        out += _varint_field(3, int(value)) + _varint_field(20, 2)  # type INT
    elif isinstance(value, int):
        out += _varint_field(3, value & ((1 << 64) - 1) if value < 0 else value)
        out += _varint_field(20, 2)
    elif isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value) + _varint_field(20, 1)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        for v in value:
            out += _varint_field(8, v & ((1 << 64) - 1) if v < 0 else v)
        out += _varint_field(20, 7)  # INTS
    elif isinstance(value, (bytes, str)):
        out += _len_field(4, value.encode() if isinstance(value, str) else value)
        out += _varint_field(20, 3)
    else:
        raise ValueError(f"unsupported attribute {name}={value!r}")
    return bytes(out)


def encode_node(
    op_type: str,
    inputs: list[str],
    outputs: list[str],
    name: str = "",
    attrs: dict | None = None,
) -> bytes:
    out = bytearray()
    for i in inputs:
        out += _len_field(1, i.encode())
    for o in outputs:
        out += _len_field(2, o.encode())
    if name:
        out += _len_field(3, name.encode())
    out += _len_field(4, op_type.encode())
    for k, v in (attrs or {}).items():
        out += _len_field(5, encode_attribute(k, v))
    return bytes(out)


def write_onnx(
    path: str | Path,
    nodes: list[bytes],
    initializers: dict[str, np.ndarray],
) -> None:
    """Assemble ModelProto{ir_version, graph{node*, initializer*}} and write."""
    graph = bytearray()
    for nb in nodes:
        graph += _len_field(1, nb)
    for name, arr in initializers.items():
        graph += _len_field(5, encode_tensor(name, arr))
    model = _varint_field(1, 8) + _len_field(7, bytes(graph))  # ir_version 8
    Path(path).write_bytes(model)
