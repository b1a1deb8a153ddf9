"""Minimal protobuf wire-format writer for ONNX (the port's own copy of
``paddle_tpu/onnx/_proto.py``).

Reference: python/paddle/onnx/export.py delegates to paddle2onnx; no
onnx package is needed here: the ModelProto is emitted directly in
protobuf wire format (varint tags + length-delimited submessages).
Field numbers follow the public onnx.proto schema (stable since IR v3);
tests re-decode the bytes with ``protoc --decode`` against a vendored
schema subset to prove conformance.
"""
from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

# onnx.TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64, BOOL = 1, 2, 3, 6, 7, 9
_NP2ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
}


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
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


def f_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(int(v))


def f_bytes(field: int, b: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(b)) + b


def f_str(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode("utf-8"))


def f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(v))


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    dt = _NP2ONNX.get(arr.dtype)
    if dt is None:
        raise NotImplementedError(f"ONNX export: dtype {arr.dtype}")
    out = b""
    for d in arr.shape:
        out += f_varint(1, d)            # dims
    out += f_varint(2, dt)               # data_type
    out += f_str(8, name)                # name
    out += f_bytes(9, np.ascontiguousarray(arr).tobytes())  # raw_data
    return out


def attr_int(name: str, v: int) -> bytes:
    return f_str(1, name) + f_varint(3, v) + f_varint(20, 2)   # type=INT


def attr_ints(name: str, vs: Sequence[int]) -> bytes:
    out = f_str(1, name)
    for v in vs:
        out += f_varint(8, v)
    return out + f_varint(20, 7)                               # type=INTS


def attr_float(name: str, v: float) -> bytes:
    return f_str(1, name) + f_float(2, v) + f_varint(20, 1)    # type=FLOAT


def attr_str(name: str, s: str) -> bytes:
    return f_str(1, name) + f_bytes(4, s.encode()) + f_varint(20, 3)


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    out = b""
    for i in inputs:
        out += f_str(1, i)
    for o in outputs:
        out += f_str(2, o)
    if name:
        out += f_str(3, name)
    out += f_str(4, op_type)
    for a in attrs:
        out += f_bytes(5, a)
    return out


def value_info(name: str, elem_type: int,
               shape: Sequence[object]) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += f_bytes(1, f_str(2, d))          # dim_param
        else:
            dims += f_bytes(1, f_varint(1, int(d)))  # dim_value
    tensor_type = f_varint(1, elem_type) + f_bytes(2, dims)
    type_proto = f_bytes(1, tensor_type)
    return f_str(1, name) + f_bytes(2, type_proto)


def graph(nodes: List[bytes], name: str, initializers: List[bytes],
          inputs: List[bytes], outputs: List[bytes]) -> bytes:
    # one join: the initializers hold the weights (~100 MB at ResNet-50)
    return b"".join([f_bytes(1, n) for n in nodes] + [f_str(2, name)]
                    + [f_bytes(5, t) for t in initializers]
                    + [f_bytes(11, i) for i in inputs]
                    + [f_bytes(12, o) for o in outputs])


def model(graph_bytes: bytes, opset: int = 13,
          producer: str = "paddle_tpu") -> bytes:
    opset_import = f_str(1, "") + f_varint(2, opset)
    out = f_varint(1, 8)                 # ir_version 8
    out += f_str(2, producer)
    out += f_bytes(7, graph_bytes)
    out += f_bytes(8, opset_import)
    return out
