"""A small evaluator of the ONNX subset ``paddle_tpu_torch.onnx`` and
``paddle_tpu.onnx`` write: it decodes the protobuf wire format of a
ModelProto and runs its nodes in order with torch ops, on any device.
A test and ``chip_smoke.py`` helper, not an ONNX runtime.

Usage::

    model = load("net.onnx")
    outs = run(model, [x])              # x: torch tensors, in input order
    histogram(model)                    # {op_type: count}
"""
from __future__ import annotations

import collections
import struct
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["load", "decode", "run", "histogram"]

_ONNX2NP = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
            7: np.int64, 9: np.bool_}
_ONNX2TORCH = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
               6: torch.int32, 7: torch.int64, 9: torch.bool}


def _varint(b, i):
    v = shift = 0
    while True:
        c = b[i]
        i += 1
        v |= (c & 0x7F) << shift
        shift += 7
        if not c & 0x80:
            return v, i


def _fields(b):
    """(field, wire type, value) of one message; a length-delimited value
    is its bytes."""
    i = 0
    while i < len(b):
        tag, i = _varint(b, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _varint(b, i)
        elif wire == 2:
            n, i = _varint(b, i)
            v, i = bytes(b[i:i + n]), i + n
        elif wire == 5:
            v, i = struct.unpack("<f", b[i:i + 4])[0], i + 4
        elif wire == 1:
            v, i = struct.unpack("<d", b[i:i + 8])[0], i + 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _signed(v):
    return v - (1 << 64) if v >= 1 << 63 else v


def _ints(wire, v):
    if wire == 0:
        return [_signed(v)]
    out, i = [], 0
    while i < len(v):                      # packed
        x, i = _varint(v, i)
        out.append(_signed(x))
    return out


def _tensor(b):
    dims, dt, name, raw = [], 1, "", b""
    for f, w, v in _fields(b):
        if f == 1:
            dims += _ints(w, v)
        elif f == 2:
            dt = v
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
    arr = np.frombuffer(raw, _ONNX2NP[dt]).reshape(dims).copy()
    return name, arr


def _attr(b):
    name, val, ints = "", None, []
    for f, w, v in _fields(b):
        if f == 1:
            name = v.decode()
        elif f == 2:
            val = v
        elif f == 3:
            val = _signed(v)
        elif f == 4:
            val = v.decode()
        elif f == 8:
            ints += _ints(w, v)
    return name, (ints if val is None else val)


def _node(b):
    node = {"input": [], "output": [], "op_type": "", "attrs": {}}
    for f, _, v in _fields(b):
        if f == 1:
            node["input"].append(v.decode())
        elif f == 2:
            node["output"].append(v.decode())
        elif f == 4:
            node["op_type"] = v.decode()
        elif f == 5:
            k, a = _attr(v)
            node["attrs"][k] = a
    return node


def _value_info_name(b):
    return next(v.decode() for f, _, v in _fields(b) if f == 1)


def decode(blob: bytes) -> dict:
    """ModelProto bytes -> {"nodes", "initializers", "inputs", "outputs",
    "opset", "producer"}."""
    model = {"nodes": [], "initializers": {}, "inputs": [], "outputs": [],
             "opset": None, "producer": ""}
    for f, _, v in _fields(blob):
        if f == 2:
            model["producer"] = v.decode()
        elif f == 8:
            model["opset"] = dict((ff, vv) for ff, _, vv in _fields(v))[2]
        elif f == 7:
            for gf, _, gv in _fields(v):
                if gf == 1:
                    model["nodes"].append(_node(gv))
                elif gf == 5:
                    k, arr = _tensor(gv)
                    model["initializers"][k] = arr
                elif gf == 11:
                    model["inputs"].append(_value_info_name(gv))
                elif gf == 12:
                    model["outputs"].append(_value_info_name(gv))
    return model


def load(path: str) -> dict:
    with open(path, "rb") as f:
        return decode(f.read())


def histogram(model: dict) -> Dict[str, int]:
    return dict(collections.Counter(n["op_type"] for n in model["nodes"]))


def _pads2d(p):
    # ONNX [top, left, bottom, right] -> symmetric torch padding
    if p[:2] != p[2:]:
        raise NotImplementedError(f"asymmetric pads {p}")
    return tuple(p[:2])


def _pool_pad(x, n):
    """Pads [begin..., end...] as explicit constant padding for torch's
    pools (so asymmetric pads work too)."""
    pads = n["attrs"].get("pads", [0, 0, 0, 0])
    k = len(pads) // 2
    pad = []
    for d in reversed(range(k)):
        pad += [pads[d], pads[d + k]]
    return pad


def _reduce_axes(n, vals, x):
    if n["op_type"] == "ReduceSum" and len(n["input"]) > 1:
        axes = vals[n["input"][1]].tolist()
    else:
        axes = n["attrs"].get("axes", list(range(x.dim())))
    return [int(a) % x.dim() for a in axes], bool(n["attrs"].get(
        "keepdims", 1))


def _op(n, vals):
    op, a = n["op_type"], n["attrs"]
    xs = [vals[i] if i else None for i in n["input"]]
    x = xs[0]
    binary = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
              "Div": torch.div, "Max": torch.maximum, "Min": torch.minimum,
              "Pow": torch.pow}
    unary = {"Neg": torch.neg, "Exp": torch.exp, "Log": torch.log,
             "Tanh": torch.tanh, "Sigmoid": torch.sigmoid,
             "Sqrt": torch.sqrt, "Reciprocal": torch.reciprocal,
             "Abs": torch.abs, "Sign": torch.sign, "Floor": torch.floor,
             "Ceil": torch.ceil, "Erf": torch.erf,
             "Identity": lambda t: t}
    if op in binary:
        y = xs[1]
        if op == "Pow" and y.dim() == 0:
            y = y.to(x.dtype)
        return binary[op](x, y)
    if op in unary:
        return unary[op](x)
    if op == "MatMul":
        return torch.matmul(x, xs[1])
    if op == "Gemm":
        aa = x.T if a.get("transA") else x
        bb = xs[1].T if a.get("transB") else xs[1]
        y = a.get("alpha", 1.0) * (aa @ bb)
        return y + a.get("beta", 1.0) * xs[2] if len(xs) > 2 else y
    if op == "Reshape":
        return x.reshape([int(d) for d in xs[1].tolist()])
    if op == "Expand":
        return x.expand([int(d) for d in xs[1].tolist()])
    if op == "Transpose":
        return x.permute(a["perm"])
    if op == "Cast":
        return x.to(_ONNX2TORCH[a["to"]])
    if op == "Where":
        return torch.where(x.bool(), xs[1], xs[2])
    if op in ("ReduceSum", "ReduceMax", "ReduceMin", "ReduceMean"):
        axes, keep = _reduce_axes(n, vals, x)
        if op == "ReduceSum":
            return x.sum(dim=axes, keepdim=keep)
        if op == "ReduceMean":
            return x.mean(dim=axes, keepdim=keep)
        f = torch.amax if op == "ReduceMax" else torch.amin
        return f(x, dim=axes, keepdim=keep)
    if op == "Softmax":
        return torch.softmax(x, dim=a.get("axis", -1))
    if op == "Conv":
        return F.conv2d(x, xs[1], xs[2] if len(xs) > 2 else None,
                        stride=a.get("strides", [1, 1]),
                        padding=_pads2d(a.get("pads", [0, 0, 0, 0])),
                        dilation=a.get("dilations", [1, 1]),
                        groups=a.get("group", 1))
    if op == "MaxPool":
        xp = F.pad(x, _pool_pad(x, n), value=float("-inf"))
        return F.max_pool2d(xp, a["kernel_shape"],
                            a.get("strides", a["kernel_shape"]),
                            dilation=a.get("dilations", [1, 1]),
                            ceil_mode=bool(a.get("ceil_mode", 0)))
    if op == "AveragePool":
        if a.get("count_include_pad", 0):
            xp = F.pad(x, _pool_pad(x, n))
            return F.avg_pool2d(xp, a["kernel_shape"],
                                a.get("strides", a["kernel_shape"]),
                                ceil_mode=bool(a.get("ceil_mode", 0)))
        return F.avg_pool2d(x, a["kernel_shape"],
                            a.get("strides", a["kernel_shape"]),
                            padding=_pads2d(a.get("pads", [0, 0, 0, 0])),
                            ceil_mode=bool(a.get("ceil_mode", 0)),
                            count_include_pad=False)
    if op == "GlobalAveragePool":
        return x.mean(dim=list(range(2, x.dim())), keepdim=True)
    raise NotImplementedError(f"onnx_eval: op {op}")


def run(model: dict, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Run ``model`` on ``inputs`` (in graph-input order); the
    initializers go to the first input's device."""
    dev = inputs[0].device
    vals = {k: torch.from_numpy(v).to(dev)
            for k, v in model["initializers"].items()}
    vals.update(zip(model["inputs"], inputs))
    with torch.no_grad():
        for n in model["nodes"]:
            vals[n["output"][0]] = _op(n, vals)
    return [vals[o] for o in model["outputs"]]
