"""onnx (``paddle_tpu.onnx``): ``export`` of a layer to ONNX.

Reference: python/paddle/onnx/export.py (paddle.onnx.export ->
paddle2onnx over the inference program).  The layer's eval forward is
captured by ``torch.export`` (non-strict, the weights as inputs, as
``jit.save`` captures it), decomposed to core ATen ops, and a
documented op subset is mapped onto ONNX nodes; anything else raises
``NotImplementedError`` naming the op.  The protobuf bytes are
hand-encoded (``onnx/_proto.py``), so no onnx package is needed.

The file is paddle_tpu's where its tests pin it: relu is ``Max`` with a
0 constant; opset-13 ``ReduceSum`` takes ``axes`` as an input (an
initializer named ``axes_*``); ``Conv`` and ``MaxPool`` carry
``kernel_shape`` and ``strides``; the weights are initializers holding
the live weights' raw bytes; inputs are named ``input_{i}``; ``None``
dims are specialised to 1.  Batch norm in eval is written out as
elementwise nodes.

Mapped ATen ops: ``mm``/``addmm``/``bmm`` -> MatMul (+ Add),
``convolution`` (NCHW, not transposed) -> Conv,
``max_pool2d_with_indices`` -> MaxPool, ``avg_pool2d`` ->
AveragePool, ``_adaptive_avg_pool2d`` to 1 x 1 and ``mean`` ->
GlobalAveragePool / ReduceMean, ``_native_batch_norm_legit_no_training``
-> Sub/Mul/Add over Reshaped statistics, add/sub/mul/div/maximum/
minimum/where/pow -> the elementwise ops, relu -> Max, the unary ops
(neg, exp, log, tanh, sigmoid, sqrt, rsqrt, abs, sign, floor, ceil,
erf, reciprocal), ``sum``/``amax``/``amin`` -> ReduceSum/Max/Min,
``_softmax`` -> Softmax, view/reshape/squeeze/unsqueeze -> Reshape,
permute/t -> Transpose, expand -> Expand, ``_to_copy`` -> Cast, clone
-> Identity.  An op with no tensor input (``arange``, ``full``) is
evaluated at export and written as an initializer.  The port's hand
kernels (``paddle_tpu_torch::*`` custom ops) have no ONNX form, as
paddle_tpu's ``pallas_call`` has none.
"""
from __future__ import annotations

import operator
import os
from typing import Dict, List

import numpy as np
import torch

from ..core.static_hooks import to_static_scope
from ..core.tensor import Tensor  # noqa: F401  (paddle_tpu's module name)
from ..jit.bind import bind, buffer_arrays, param_list  # noqa: F401
from . import _proto as P

__all__ = ["export"]

_aten = torch.ops.aten

_ELEMWISE = {
    _aten.add.Tensor: "Add", _aten.sub.Tensor: "Sub",
    _aten.mul.Tensor: "Mul", _aten.div.Tensor: "Div",
    _aten.maximum.default: "Max", _aten.minimum.default: "Min",
    _aten.pow.Tensor_Tensor: "Pow", _aten.pow.Tensor_Scalar: "Pow",
    _aten.add.Scalar: "Add", _aten.sub.Scalar: "Sub",
    _aten.mul.Scalar: "Mul", _aten.div.Scalar: "Div",
}

_UNARY = {
    _aten.neg.default: "Neg", _aten.exp.default: "Exp",
    _aten.log.default: "Log", _aten.tanh.default: "Tanh",
    _aten.sigmoid.default: "Sigmoid", _aten.sqrt.default: "Sqrt",
    _aten.abs.default: "Abs", _aten.sign.default: "Sign",
    _aten.floor.default: "Floor", _aten.ceil.default: "Ceil",
    _aten.erf.default: "Erf", _aten.reciprocal.default: "Reciprocal",
    _aten.clone.default: "Identity", _aten.alias.default: "Identity",
    _aten.detach.default: "Identity",
}

_RESHAPES = {_aten.view.default, _aten._unsafe_view.default,
             _aten.reshape.default, _aten.squeeze.dim, _aten.squeeze.dims,
             _aten.squeeze.default, _aten.unsqueeze.default}

_REDUCE = {_aten.sum.dim_IntList: "ReduceSum", _aten.amax.default:
           "ReduceMax", _aten.amin.default: "ReduceMin",
           _aten.mean.dim: "ReduceMean"}

_TORCH2NP = {torch.float32: np.float32, torch.int64: np.int64,
             torch.int32: np.int32, torch.int8: np.int8,
             torch.uint8: np.uint8, torch.bool: np.bool_}


def _np_of(t: torch.Tensor) -> np.ndarray:
    t = torch.Tensor.as_subclass(t.detach(), torch.Tensor).cpu()
    if t.dtype not in _TORCH2NP:
        raise NotImplementedError(f"ONNX export: dtype {t.dtype}")
    return t.contiguous().numpy()


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


class _Converter:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.names: Dict[torch.fx.Node, str] = {}
        self.counter = 0

    def fresh(self, hint="t"):
        self.counter += 1
        return f"{hint}_{self.counter}"

    def add_const(self, arr: np.ndarray, hint="const"):
        nm = self.fresh(hint)
        self.initializers.append(P.tensor_proto(nm, np.asarray(arr)))
        return nm

    def emit(self, op, ins, attrs=(), hint=None):
        out = self.fresh(hint or op.lower())
        self.nodes.append(P.node(op, ins, [out], name=out + "_node",
                                 attrs=list(attrs)))
        return out

    def name_of(self, arg, like=None):
        """An input's ONNX name: a graph value, or a Python scalar as a
        0-d constant of ``like``'s dtype."""
        if isinstance(arg, torch.fx.Node):
            return self.names[arg]
        dt = _TORCH2NP.get(getattr(_val(like), "dtype", None), np.float32)
        return self.add_const(np.asarray(arg, dt))

    def shape_const(self, shape):
        return self.add_const(np.asarray(list(shape), np.int64), "shape")

    # -- the conversion ----------------------------------------------------
    def convert(self, ep, weights, in_names):
        """``ep``'s nodes onto ONNX nodes: its user inputs are
        ``weights`` (initializers, those the graph reads) and then the
        graph inputs ``in_names``; returns the output names."""
        user = iter([("w", w) for w in weights]
                    + [("in", nm) for nm in in_names])
        consts = dict(ep.constants)
        for spec, node in zip(ep.graph_signature.input_specs,
                              [n for n in ep.graph.nodes
                               if n.op == "placeholder"]):
            if spec.kind == spec.kind.USER_INPUT:
                kind, v = next(user)
                if kind == "in":
                    self.names[node] = v
                elif node.users:
                    self.names[node] = self.add_const(v, "param")
            else:                   # a constant the export lifted
                val = consts.get(spec.target)
                if val is None:
                    val = ep.state_dict[spec.target]
                self.names[node] = self.add_const(_np_of(val), "param")
        outs = []
        for node in ep.graph.nodes:
            if node.op == "call_function":
                self._node(node)
            elif node.op == "output":
                outs = [self.names[a] for a in
                        torch.utils._pytree.tree_leaves(node.args[0])]
        return outs

    def _node(self, node):
        t = node.target
        a = node.args

        def out(name):
            self.names[node] = name

        if t is operator.getitem:
            src, i = a
            if src.target in (_aten.max_pool2d_with_indices.default,
                              _aten._native_batch_norm_legit_no_training
                              .default) and i != 0:
                if node.users:
                    raise NotImplementedError(
                        f"ONNX export: output {i} of {src.target}")
                return
            out(self.names[src])
            return
        ns = getattr(t, "namespace", None)
        if ns not in (None, "aten"):
            raise NotImplementedError(
                f"ONNX export: op '{t._schema.name}' is outside the "
                f"supported subset (a custom op: a hand kernel has no "
                f"ONNX form)")
        tensor_in = [x for x in torch.utils._pytree.tree_leaves((a,
                     node.kwargs)) if isinstance(x, torch.fx.Node)]
        if not tensor_in and isinstance(_val(node), torch.Tensor):
            # a constant the forward makes (arange, full, ...)
            kw = dict(node.kwargs, device="cpu") if "device" in \
                node.kwargs else node.kwargs
            out(self.add_const(_np_of(t(*a, **kw))))
            return
        if t in _ELEMWISE:
            alpha = node.kwargs.get("alpha", 1)
            if alpha != 1:
                raise NotImplementedError(f"ONNX export: {t} with alpha")
            out(self.emit(_ELEMWISE[t], [self.name_of(a[0], a[1]),
                                         self.name_of(a[1], a[0])]))
            return
        if t is _aten.relu.default:
            zero = self.add_const(np.asarray(0.0, np.float32))
            out(self.emit("Max", [self.names[a[0]], zero]))
            return
        if t in _UNARY:
            out(self.emit(_UNARY[t], [self.names[a[0]]]))
            return
        if t is _aten.rsqrt.default:
            s = self.emit("Sqrt", [self.names[a[0]]])
            out(self.emit("Reciprocal", [s]))
            return
        if t is _aten.where.self:
            out(self.emit("Where", [self.name_of(x, node) for x in a]))
            return
        if t is _aten._to_copy.default:
            dt = node.kwargs.get("dtype")
            to = (P._NP2ONNX.get(np.dtype(_TORCH2NP[dt]))
                  if dt in _TORCH2NP else None)
            if dt is None:
                out(self.emit("Identity", [self.names[a[0]]]))
                return
            if to is None:
                raise NotImplementedError(f"ONNX export: cast to {dt}")
            out(self.emit("Cast", [self.names[a[0]]],
                          attrs=[P.attr_int("to", to)]))
            return
        if t in _RESHAPES:
            shp = self.shape_const(_val(node).shape)
            out(self.emit("Reshape", [self.names[a[0]], shp]))
            return
        if t is _aten.permute.default:
            out(self.emit("Transpose", [self.names[a[0]]],
                          attrs=[P.attr_ints("perm", list(a[1]))]))
            return
        if t is _aten.t.default:
            out(self.emit("Transpose", [self.names[a[0]]],
                          attrs=[P.attr_ints("perm", [1, 0])]))
            return
        if t is _aten.expand.default:
            shp = self.shape_const(_val(node).shape)
            out(self.emit("Expand", [self.names[a[0]], shp]))
            return
        if t in (_aten.mm.default, _aten.bmm.default):
            out(self.emit("MatMul", [self.names[a[0]], self.names[a[1]]]))
            return
        if t is _aten.addmm.default:
            if node.kwargs.get("beta", 1) != 1 or \
                    node.kwargs.get("alpha", 1) != 1:
                raise NotImplementedError("ONNX export: addmm with "
                                          "alpha/beta")
            mm = self.emit("MatMul", [self.names[a[1]], self.names[a[2]]])
            out(self.emit("Add", [mm, self.names[a[0]]]))
            return
        if t in _REDUCE:
            self._reduce(node, _REDUCE[t])
            return
        if t is _aten._softmax.default:
            out(self.emit("Softmax", [self.names[a[0]]],
                          attrs=[P.attr_int("axis", int(a[1]))]))
            return
        if t is _aten.convolution.default:
            self._conv(node)
            return
        if t is _aten.max_pool2d_with_indices.default:
            x, k = a[0], list(a[1])
            s = list(a[2]) if len(a) > 2 and a[2] else k
            p = list(a[3]) if len(a) > 3 else [0, 0]
            d = list(a[4]) if len(a) > 4 else [1, 1]
            ceil = bool(a[5]) if len(a) > 5 else False
            attrs = [P.attr_ints("kernel_shape", k),
                     P.attr_ints("strides", s),
                     P.attr_ints("pads", p + p),
                     P.attr_ints("dilations", d),
                     P.attr_int("ceil_mode", int(ceil))]
            out(self.emit("MaxPool", [self.names[x]], attrs=attrs))
            return
        if t is _aten.avg_pool2d.default:
            x, k = a[0], list(a[1])
            s = list(a[2]) if len(a) > 2 and a[2] else k
            p = list(a[3]) if len(a) > 3 else [0, 0]
            ceil = bool(a[4]) if len(a) > 4 else False
            cip = bool(a[5]) if len(a) > 5 else True
            if len(a) > 6 and a[6] is not None:
                raise NotImplementedError("ONNX export: avg_pool2d with "
                                          "divisor_override")
            attrs = [P.attr_ints("kernel_shape", k),
                     P.attr_ints("strides", s),
                     P.attr_ints("pads", p + p),
                     P.attr_int("ceil_mode", int(ceil)),
                     P.attr_int("count_include_pad", int(cip))]
            out(self.emit("AveragePool", [self.names[x]], attrs=attrs))
            return
        if t is _aten._adaptive_avg_pool2d.default:
            if tuple(a[1]) != (1, 1):
                raise NotImplementedError(
                    f"ONNX export: adaptive average pool to {tuple(a[1])}")
            out(self.emit("GlobalAveragePool", [self.names[a[0]]]))
            return
        if t is _aten._native_batch_norm_legit_no_training.default:
            self._batch_norm(node)
            return
        raise NotImplementedError(
            f"ONNX export: op '{getattr(t, '__name__', t)}' is outside the "
            f"supported subset (see paddle_tpu_torch.onnx's docstring); "
            f"simplify the model or extend the mapping")

    def _reduce(self, node, op):
        x, dims = node.args[0], node.args[1]
        keep = bool(node.args[2]) if len(node.args) > 2 else \
            bool(node.kwargs.get("keepdim", False))
        rank = len(_val(x).shape)
        axes = [int(d) % rank for d in (dims if dims else range(rank))]
        if op == "ReduceSum":
            # opset 13 moved ReduceSum's axes from attribute to a second
            # INPUT (ReduceMax/Min/Mean move only at opset 18)
            ax = self.add_const(np.asarray(axes, np.int64), "axes")
            self.names[node] = self.emit(
                op, [self.names[x], ax],
                attrs=[P.attr_int("keepdims", int(keep))])
            return
        self.names[node] = self.emit(
            op, [self.names[x]], attrs=[P.attr_ints("axes", axes),
                                        P.attr_int("keepdims", int(keep))])

    def _conv(self, node):
        (x, w, b, stride, padding, dilation, transposed, _,
         groups) = node.args[:9]
        if transposed or len(_val(x).shape) != 4:
            raise NotImplementedError(
                "ONNX export: convolution other than 2-D, NCHW, not "
                "transposed")
        kshape = list(_val(w).shape[2:])
        attrs = [P.attr_ints("kernel_shape", kshape),
                 P.attr_ints("strides", list(stride)),
                 P.attr_ints("dilations", list(dilation)),
                 P.attr_ints("pads", list(padding) + list(padding)),
                 P.attr_int("group", int(groups))]
        ins = [self.names[x], self.names[w]] + (
            [self.names[b]] if b is not None else [])
        self.names[node] = self.emit("Conv", ins, attrs=attrs)

    def _batch_norm(self, node):
        """Eval batch norm as elementwise nodes:
        (x - mean) * (weight / sqrt(var + eps)) + bias, the statistics
        reshaped to [1, C, 1, ...]."""
        x, w, b, mean, var, _, eps = node.args[:7]
        rank = len(_val(x).shape)
        shape = [1, -1] + [1] * (rank - 2)

        def col(arg):
            return self.emit("Reshape", [self.names[arg],
                                         self.shape_const(shape)])

        e = self.add_const(np.asarray(eps, np.float32))
        std = self.emit("Sqrt", [self.emit("Add", [self.names[var], e])])
        inv = (self.emit("Div", [self.names[w], std]) if w is not None
               else self.emit("Reciprocal", [std]))
        scale = self.emit("Reshape", [inv, self.shape_const(shape)])
        y = self.emit("Mul", [self.emit("Sub", [self.names[x], col(mean)]),
                              scale])
        self.names[node] = (self.emit("Add", [y, col(b)]) if b is not None
                            else y)


def _specs(input_spec):
    from ..core.dtype import convert_dtype
    from ..jit.static_function import InputSpec
    specs = []
    for s in (input_spec or []):
        if isinstance(s, InputSpec):
            shape = [1 if d is None or d < 0 else int(d) for d in s.shape]
            specs.append((shape, convert_dtype(s.dtype)))
        elif isinstance(s, torch.Tensor):
            specs.append((list(s.shape), s.dtype))
        else:
            a = np.asarray(s)
            specs.append((list(a.shape), torch.from_numpy(a[:0]).dtype))
    if not specs:
        raise ValueError("paddle.onnx.export needs input_spec")
    return specs


def export(layer, path: str, input_spec=None, opset_version: int = 13,
           **configs) -> str:
    """Export ``layer`` to ``<path>.onnx`` (reference: paddle.onnx.export).

    ``input_spec``: list of InputSpec/arrays fixing input shapes.  The
    exported graph is shape-specialised: a ``None`` dim is traced (and
    recorded) as 1, so export again for another batch size, as the
    Predictor's shape buckets are compiled one by one.  The example
    inputs are made on the device of the layer's weights."""
    specs = _specs(input_spec)
    named_p = list(layer.named_parameters())
    named_b = list(layer.named_buffers())
    n_p, n_b = len(named_p), len(named_b)
    state = [t for _, t in named_p + named_b]
    dev = state[0].device if state else torch.device("cpu")
    examples = [torch.zeros(shape, dtype=dt, device=dev)
                for shape, dt in specs]

    class _Program(torch.nn.Module):
        def forward(self, *flat):
            with bind(layer, flat[:n_p], flat[n_p:n_p + n_b]):
                return layer(*flat[n_p + n_b:])

    was_training = layer.training
    layer.eval()
    try:
        plain = [torch.Tensor.as_subclass(t.detach(), torch.Tensor)
                 for t in state]
        with torch.no_grad(), to_static_scope():
            ep = torch.export.export(_Program(), tuple(plain)
                                     + tuple(examples), strict=False)
            ep = ep.run_decompositions()
    finally:
        if was_training:
            layer.train()
    conv = _Converter()
    in_names = [f"input_{i}" for i in range(len(specs))]
    out_names = conv.convert(ep, [_np_of(t) for t in state], in_names)

    def vinfo(nm, dtype, shape):
        return P.value_info(nm, P._NP2ONNX[np.dtype(_TORCH2NP[dtype])],
                            list(shape))

    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    out_vals = [_val(a) for a in
                torch.utils._pytree.tree_leaves(out_node.args[0])]
    g_inputs = [vinfo(nm, dt, shape)
                for nm, (shape, dt) in zip(in_names, specs)]
    g_outputs = [vinfo(nm, v.dtype, v.shape)
                 for nm, v in zip(out_names, out_vals)]
    gb = P.graph(conv.nodes, type(layer).__name__, conv.initializers,
                 g_inputs, g_outputs)
    mb = P.model(gb, opset=opset_version, producer="paddle_tpu_torch")
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(mb)
    return out_path
