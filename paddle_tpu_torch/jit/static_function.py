"""``jit.to_static`` and ``InputSpec`` (the counterpart of
``paddle_tpu/jit/static_function.py``).

paddle_tpu traces a ``to_static`` function with JAX and compiles it; the
port runs it eagerly, as PyTorch runs ``jit.TrainStep``.  What it keeps
of static mode is the function's form: its tensor ``if``/``while`` are
converted by :mod:`.dy2static` to ``cond``/``while_loop``, and a Python
``if`` on a tensor that the converter left alone raises (the paddle
Tensor's truth value raises inside the call), so a function that runs
under ``to_static`` is one ``jit.save`` can capture with every branch.
Outputs, gradients, buffer updates (batch norm's running statistics)
and random draws (dropout under ``paddle.seed``) are eager's.

Each new input structure (the nesting of the arguments, their
non-tensor values, the layer's training flag) is what paddle_tpu traces
and compiles anew; the port reports it to
``observability.record_compile`` (component ``jit``) as its capture,
with paddle_tpu's cause names.  Captures are keyed as paddle_tpu keys
its traces, by the hash of the static values (``1`` and ``1.0`` are one
capture); a call with an unhashable value (a numpy array) is a capture
of its own every time, ``new_uncacheable_call``.
"""
from __future__ import annotations

import functools
import inspect
import itertools
from typing import Callable, Optional

import torch

from ..core.dtype import convert_dtype
from ..core.static_hooks import to_static_scope

__all__ = ["InputSpec", "StaticFunction", "to_static", "enable_to_static",
           "not_to_static"]

_SERIALS = itertools.count(1)


class _TensorLeaf:
    """The marker a tensor leaves among a call's static leaves."""

    def __repr__(self):
        return "<tensor>"


_TENSOR_LEAF = _TensorLeaf()


def _structure(obj, leaves: list) -> str:
    """The nesting of ``obj`` with every leaf a ``*``; non-tensor
    leaves are appended to ``leaves`` (tensors as a marker)."""
    if isinstance(obj, torch.Tensor):
        leaves.append(_TENSOR_LEAF)
        return "*"
    if isinstance(obj, (list, tuple)):
        inner = ",".join(_structure(x, leaves) for x in obj)
        return f"{type(obj).__name__}({inner})"
    if isinstance(obj, dict):
        inner = ",".join(f"{k!r}:{_structure(obj[k], leaves)}"
                         for k in sorted(obj, key=repr))
        return "{" + inner + "}"
    leaves.append(obj)
    return "*"


class InputSpec:
    """reference: paddle.static.InputSpec.  ``None`` or a negative size
    is a dynamic dim: ``jit.save`` exports it as a ``torch.export``
    dynamic dim."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    @property
    def torch_dtype(self):
        return convert_dtype(self.dtype)

    def dynamic_dims(self):
        """Positions of the dynamic dims."""
        return [i for i, s in enumerate(self.shape)
                if s is None or (isinstance(s, int) and s < 0)]

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _flatten(obj, leaves: list):
    """The leaves of ``obj`` (lists, tuples and dicts opened, dicts by
    sorted key as in :func:`_structure`) appended to ``leaves``; returns
    the function that rebuilds ``obj`` from an iterator of leaves."""
    if isinstance(obj, (list, tuple)):
        parts = [_flatten(x, leaves) for x in obj]
        kind = type(obj)
        return lambda it: kind(p(it) for p in parts)
    if isinstance(obj, dict):
        keys = sorted(obj, key=repr)
        parts = [_flatten(obj[k], leaves) for k in keys]
        return lambda it: {k: p(it) for k, p in zip(keys, parts)}
    leaves.append(obj)
    return lambda it: next(it)


def _find_layer(fn) -> Optional[object]:
    if isinstance(fn, torch.nn.Module):
        return fn
    owner = getattr(fn, "__self__", None)
    return owner if isinstance(owner, torch.nn.Module) else None


class StaticFunction:
    """``fn`` with its control flow converted, run eagerly inside the
    ``to_static`` scope.  ``enable_to_static(False)`` runs the original
    function instead."""

    _enabled = True
    _NONCE = itertools.count(1)     # uncacheable captures, in order

    def __init__(self, fn: Callable, input_spec=None, layer=None):
        self._raw = fn.forward if layer is not None and fn is layer else fn
        self._layer = layer if layer is not None else _find_layer(fn)
        self._input_spec = input_spec
        self._fn = self._convert_control_flow(self._raw)
        functools.update_wrapper(self, self._fn)
        self._serial = next(_SERIALS)   # compile-attribution identity
        self._captured: set = set()     # input structures seen

    @staticmethod
    def _convert_control_flow(fn):
        from .dy2static import convert_control_flow
        raw = fn.__func__ if inspect.ismethod(fn) else fn
        conv = convert_control_flow(raw)
        if conv is raw:
            return fn
        if inspect.ismethod(fn):
            return conv.__get__(fn.__self__)
        return conv

    @property
    def layer(self):
        return self._layer

    def __call__(self, *args, **kwargs):
        if not StaticFunction._enabled:
            return self._raw(*args, **kwargs)
        self._note_capture(args, kwargs)
        with to_static_scope():
            return self._fn(*args, **kwargs)

    def _note_capture(self, args, kwargs) -> None:
        leaves: list = []
        struct = _structure((args, kwargs), leaves)
        training = (bool(self._layer.training)
                    if self._layer is not None else False)
        static_leaves = tuple(leaves)
        sig = {}
        try:
            key = (struct, static_leaves, training)
            if key in self._captured:
                return
            self._captured.add(key)
        except TypeError:   # an unhashable leaf: captured on every call
            sig["uncacheable_call"] = next(StaticFunction._NONCE)
        sig["input_structure"] = (struct, repr(static_leaves))
        sig["training"] = training
        from ..observability import record_compile
        record_compile("jit", self._serial, sig)

    def concrete(self, *example_args, **example_kwargs):
        """``(pure_fn, tensor_args)``, paddle_tpu's pair for export.

        ``pure_fn(key, *params, *buffers, *inputs)`` returns ``(outputs,
        new_buffers)``: the function on ``inputs`` (the call's tensors,
        in the order of ``tensor_args``; its other arguments are the
        example call's) with the layer's parameters and buffers bound to
        the given tensors (:func:`.bind.bind`, in ``named_parameters()``
        / ``named_buffers()`` order), every random draw from the stream
        of the int seed ``key`` (``F.next_key()`` gives one; paddle_tpu's
        key is a threefry key), and no gradient recorded.  The buffers
        given are not written: ``new_buffers`` are copies holding the
        call's updates (batch norm's running statistics in training
        mode).  ``tensor_args`` are the example call's tensors.

        The port compiles nothing ahead of time: ``pure_fn`` runs the
        function eagerly, as a ``to_static`` call does."""
        from ..core import rng
        from .bind import bind, buffer_names, param_list
        leaves: list = []
        rebuild = _flatten((example_args, example_kwargs), leaves)
        tensor_args = [x for x in leaves if isinstance(x, torch.Tensor)]
        fixed = [_TENSOR_LEAF if isinstance(x, torch.Tensor) else x
                 for x in leaves]
        layer, fn = self._layer, self._fn
        n_p = len(param_list(layer)) if layer is not None else 0
        bnames = buffer_names(layer) if layer is not None else []
        n_b = len(bnames)

        def pure_fn(key, *arrays):
            if len(arrays) != n_p + n_b + len(tensor_args):
                raise TypeError(
                    f"concrete: {len(arrays)} tensors for {n_p} parameters"
                    f", {n_b} buffers and {len(tensor_args)} inputs")
            params = list(arrays[:n_p])
            buffers = [b.clone() for b in arrays[n_p:n_p + n_b]]
            inputs = iter(arrays[n_p + n_b:])
            args, kwargs = rebuild(iter(
                next(inputs) if x is _TENSOR_LEAF else x for x in fixed))
            with torch.no_grad(), rng.seed_scope(int(key)), \
                    to_static_scope():
                if layer is None:
                    return fn(*args, **kwargs), ()
                with bind(layer, params, buffers) as res:
                    out = fn(*args, **kwargs)
            return out, tuple(res.new_buffers.get(n, b)
                              for n, b in zip(bnames, buffers))

        return pure_fn, tensor_args

    def __get__(self, instance, owner=None):
        """``@to_static`` on a method binds per instance."""
        if instance is None:
            return self
        key = "_static_fn_" + self._raw.__name__
        cached = getattr(instance, "__dict__", {}).get(key)
        if cached is not None:
            return cached
        layer = instance if isinstance(instance, torch.nn.Module) else None
        bound = StaticFunction(self._raw.__get__(instance, owner),
                               self._input_spec, layer=layer)
        try:
            object.__setattr__(instance, key, bound)
        except (AttributeError, TypeError):
            pass
        return bound


def to_static(function=None, input_spec=None, build_strategy=None,
              **kwargs):
    """``@paddle.jit.to_static`` (reference: dygraph/jit.py:160): on a
    Layer it replaces ``forward``; on a function or method it returns
    a :class:`StaticFunction`."""
    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(fn.forward, input_spec, layer=fn)
            return fn
        return StaticFunction(fn, input_spec)
    if function is not None:
        return decorate(function)
    return decorate


def enable_to_static(flag: bool = True):
    StaticFunction._enabled = bool(flag)


def not_to_static(fn):
    return fn
