"""The paddle ``Tensor`` and ``Parameter`` over ``torch.Tensor`` (the
counterparts of ``paddle_tpu.core.tensor``).

:class:`Tensor` is a ``torch.Tensor`` subclass whose
``__torch_function__`` is disabled, as ``torch.nn.Parameter``'s is: a
torch op on it pays no Python dispatch and returns a plain
``torch.Tensor``.  The paddle op boundary makes paddle Tensors: every
eager result of a paddle op (``core.dispatch.apply``), of a Tensor
method or operator, and of a creation op is re-typed in place by
:func:`wrap` (``__class__`` assignment: no copy, no autograd node).
torch's autograd is the tape.

What the type adds to ``torch.Tensor``:

- ``shape`` is a list (a :class:`Shape`: equal to the list and to the
  tuple of the same sizes, hashable, concatenable with either), as in
  paddle_tpu; ``size`` stays torch's method (torch calls it
  internally), so ``x.size`` is not paddle's element count (use
  ``x.numel()`` or ``paddle.numel``);
- ``stop_gradient`` is ``not requires_grad``: ``to_tensor`` defaults to
  True, a :class:`Parameter` to False;
- ``numpy()`` copies from the card and detaches (torch's raises on
  both); ``grad`` is a paddle Tensor; ``backward``, ``clear_grad``,
  ``register_hook``, ``set_value``, ``astype``, ``place`` behave as in
  paddle_tpu;
- its truth value (``if x:``) raises inside ``jit.to_static``, as
  paddle_tpu's traced Tensor's does (``core.static_hooks``).

The paddle methods of :mod:`paddle_tpu_torch.ops` (``sum(axis=...)``,
``transpose(perm)``, ``reshape(shape)``, ...) are installed by
``ops.monkey_patch_tensor``.  Where a paddle method shares its name
with a torch method of another signature (``transpose``, ``sum``,
``gather``, ``max``, ...) the method takes both calling conventions, so
torch's own code and the port's keep working on paddle Tensors.
"""
from __future__ import annotations

import copy
import itertools
from typing import Optional

import numpy as np
import torch

from .dtype import convert_dtype, dtype_name, get_default_dtype
from .placement import device as _resolve_device
from .static_hooks import in_to_static

__all__ = ["Tensor", "Parameter", "Shape", "to_tensor", "wrap",
           "raw_grad"]

_TB = torch._C.TensorBase
_GRAD = _TB.grad
_SHAPE = _TB.shape


class Shape(list):
    """A paddle shape: a list of ints that also equals the tuple (and
    ``torch.Size``) of the same sizes, hashes like it, and concatenates
    with either."""

    __slots__ = ()

    def __eq__(self, other):
        if isinstance(other, (list, tuple)):
            return list.__eq__(self, list(other))
        return NotImplemented

    def __ne__(self, other):
        r = self.__eq__(other)
        return r if r is NotImplemented else not r

    def __hash__(self):
        return hash(tuple(self))

    def __getitem__(self, i):
        r = list.__getitem__(self, i)
        return Shape(r) if isinstance(i, slice) else r

    def __add__(self, other):
        return Shape(list(self) + list(other))

    def __radd__(self, other):
        return Shape(list(other) + list(self))


def wrap(out):
    """Re-type a torch op's result as paddle Tensor(s), in place: a
    plain ``torch.Tensor`` becomes a :class:`Tensor`; a tuple or list
    is wrapped item by item (a torch named tuple keeps its fields).
    While torch compiles or exports (the branches of ``torch.cond`` and
    the body of ``while_loop`` are traced by dynamo), tensors stay
    torch's: a traced graph holds no subclass."""
    t = type(out)
    if t is torch.Tensor:
        if not torch.compiler.is_compiling():
            out.__class__ = Tensor
        return out
    if t is tuple or t is list:
        return t(wrap(o) for o in out)
    if isinstance(out, tuple):       # torch.return_types: keep the fields
        for o in out:
            wrap(o)
    return out


def raw_grad(t):
    """``t``'s gradient as torch holds it: dense, or the ``sparse_coo``
    tensor of a sparse embedding (``Tensor.grad`` densifies that)."""
    return _GRAD.__get__(t)


def _plain(x):
    """``x`` as a detached host-side plain tensor (for numpy)."""
    t = _TB.detach(x)
    if t.device.type != "cpu":
        t = t.cpu()
    return t


_name_counter = itertools.count(0)


class Tensor(torch.Tensor):
    __torch_function__ = torch._C._disabled_torch_function_impl

    persistable = False

    # -- metadata ----------------------------------------------------------
    @property
    def name(self) -> str:
        """paddle's tensor name: the ``param_name`` a layer, a
        ``ParamAttr`` or an assignment gave it, else ``tensor_N`` from a
        counter, drawn the first time the name is read (torch's own
        ``Tensor.name`` is a read-only None, replaced here)."""
        d = self.__dict__
        n = d.get("param_name")
        if n is None:
            n = d.get("_auto_name")
            if n is None:
                n = d["_auto_name"] = f"tensor_{next(_name_counter)}"
        return n

    @name.setter
    def name(self, value):
        self.__dict__["param_name"] = value

    @property
    def shape(self) -> Shape:
        return Shape(_SHAPE.__get__(self))

    @property
    def place(self) -> str:
        return str(self.device)

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        if self.is_leaf:
            self.requires_grad_(not value)
        elif value:
            # a produced tensor stops the gradient: it leaves the graph
            _TB.detach_(self)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self.requires_grad_(bool(value))

    # -- autograd ----------------------------------------------------------
    @property
    def grad(self) -> Optional["Tensor"]:
        """The gradient, dense: a sparse embedding gradient (a
        ``sparse_coo`` tensor in torch's slot) is densified into a new
        tensor, as paddle_tpu's user view is; the optimizers read the
        sparse one (:func:`raw_grad`)."""
        g = _GRAD.__get__(self)
        if g is not None and g.is_sparse:
            return wrap(g.to_dense())
        if type(g) is torch.Tensor:
            g.__class__ = Tensor
        return g

    @grad.setter
    def grad(self, value):
        _GRAD.__set__(self, value)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from . import autograd
        autograd.backward(self, grad_tensor, retain_graph)

    def clear_grad(self, set_to_zero=False):
        _GRAD.__set__(self, None)

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """Run ``hook(grad)`` when this tensor's gradient flows; a
        returned tensor replaces the gradient.  The handle's
        ``remove()`` takes the hook off."""
        return torch.Tensor.register_hook(self, lambda g: hook(wrap(g)))

    def detach(self) -> "Tensor":
        return wrap(_TB.detach(self))

    def clone(self) -> "Tensor":
        return wrap(_TB.clone(self))

    # -- host interop ------------------------------------------------------
    def numpy(self) -> np.ndarray:
        t = _plain(self)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return torch.Tensor.numpy(t)

    def tolist(self):
        return _plain(self).tolist()

    def __bool__(self):
        if in_to_static():
            raise TypeError(
                "[operator < bool > error] Python `if`/`while` tested a "
                "Tensor inside paddle.jit.to_static; the branch cannot be "
                "kept in a saved program and would silently freeze one "
                "path into it. Use paddle.cond / paddle.where for "
                "branches, paddle.while_loop for loops, or mark the "
                "function non-static.")
        return _TB.__bool__(self)

    def __float__(self):
        return float(_TB.item(_TB.detach(self)))

    def __int__(self):
        return int(_TB.item(_TB.detach(self)))

    def __repr__(self, *, tensor_contents=None):
        try:
            body = np.array2string(self.numpy(), precision=8,
                                   separator=", ")
        except Exception as e:   # a tensor without storage
            body = f"<{type(e).__name__}>"
        return (f"Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)},"
                f" place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {body})")

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        with torch.no_grad():
            out = _TB.clone(self)
        out.__class__ = type(self)
        if self.is_leaf and self.requires_grad:
            out.requires_grad_(True)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    # -- in-place helpers ----------------------------------------------------
    def set_value(self, value):
        """Overwrite the values (same shape; cast to this dtype)."""
        v = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value)
        if tuple(v.shape) != tuple(_SHAPE.__get__(self)):
            raise ValueError(f"set_value shape mismatch: {list(v.shape)} vs "
                             f"{self.shape}")
        with torch.no_grad():
            _TB.copy_(self, v.to(self.dtype))
        return self

    def zero_(self):
        with torch.no_grad():
            _TB.zero_(self)
        return self

    def fill_(self, value):
        with torch.no_grad():
            _TB.fill_(self, value)
        return self

    # -- dtype and device ----------------------------------------------------
    def astype(self, dtype) -> "Tensor":
        return wrap(_TB.to(self, convert_dtype(dtype)))

    cast = astype

    def cpu(self):
        return wrap(_TB.cpu(self))

    def cuda(self, *args, **kwargs):
        return wrap(_TB.cuda(self, *args, **kwargs))

    def pin_memory(self):
        return self


class Parameter(Tensor, torch.nn.Parameter):
    """A trainable paddle Tensor that ``torch.nn.Module`` registers (it
    is a ``torch.nn.Parameter``).  ``trainable`` is ``requires_grad``;
    ``regularizer``, ``need_clip`` and ``optimize_attr["learning_rate"]``
    are read by the optimizers; a name is kept as ``param_name`` (torch
    reserves ``Tensor.name``)."""

    persistable = True
    regularizer = None
    need_clip = True

    def __new__(cls, data=None, requires_grad=True, name=None,
                trainable=None, regularizer=None, need_clip=True):
        if isinstance(requires_grad, str):          # Parameter(data, name)
            requires_grad, name = True, requires_grad
        if trainable is not None:
            requires_grad = bool(trainable)
        if data is None:
            data = torch.empty(0)
        elif not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        p = torch.Tensor._make_subclass(cls, _TB.detach(data),
                                        bool(requires_grad))
        if name is not None:
            p.param_name = name
        if regularizer is not None:
            p.regularizer = regularizer
        if not need_clip:
            p.need_clip = False
        return p

    def __init__(self, *args, **kwargs):
        pass

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(_TB.clone(self.data), self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __repr__(self, *, tensor_contents=None):
        return "Parameter containing:\n" + super().__repr__()


def _host_array(data, dtype):
    """numpy view of Python or numpy data, with paddle's dtype rules:
    Python floats take the default dtype; ints stay int64."""
    a = np.asarray(data)
    if dtype is None and not hasattr(data, "dtype") and a.dtype == np.float64:
        a = a.astype(np.dtype(dtype_name(get_default_dtype()))
                     if get_default_dtype() != torch.bfloat16 else np.float32)
    return a


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy kernel
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``paddle.to_tensor``: a new Tensor (a copy) on ``place`` (the
    device ``set_device`` chose, else the current CUDA device; raises
    without one), of ``dtype`` (default: the data's, Python floats the
    default dtype), with ``stop_gradient``."""
    dev = _resolve_device(place)
    if isinstance(data, torch.Tensor):
        t = _TB.detach(data).to(dev, copy=True)
    else:
        t = _from_numpy(_host_array(data, dtype)).to(dev)
    if dtype is not None:
        t = t.to(convert_dtype(dtype))
    t.__class__ = Tensor
    if not stop_gradient:
        t.requires_grad_(True)
    return t
