"""paddle_tpu_torch.ops — the op library (``paddle_tpu.ops``).

:func:`monkey_patch_tensor` puts the op surface on the paddle
:class:`~..core.tensor.Tensor` as methods and operators, as the JAX
package patches its Tensor:

- a method ``x.op(*args)`` is the paddle op ``op(x, *args)``, run with
  ``auto_cast`` suspended (so a method called inside a model's forward
  keeps the dtypes it had before methods existed);
- an operator (``+``, ``@``, ``<``, ``x[i]``, ...) is torch's operator
  on the tensors, re-typed as a paddle Tensor: no dispatch, no cast;
- where torch has a method of the same name and another signature, a
  call in torch's form runs torch's method: ``transpose(0, 1)`` (two
  ints), ``sum(-1, True)`` (a bool second argument), ``gather(1, idx)``
  and ``index_select(0, idx)`` (an int first), a ``dim=`` or ``out=``
  keyword, a call of ``split`` from ``torch.split``, ...  Paddle's form
  is everything else, so ``x.max(1)`` is paddle's (the values),
  ``x.max(dim=1)`` torch's (values, indices), and ``x.split(2)`` cuts
  two equal sections where torch's cuts sections of 2.

The methods come from one table (``_method_table``); the static
``Variable`` takes the same table, and the operators as paddle ops, from
:func:`symbolic_methods`, so each records one node.
"""
from __future__ import annotations

import builtins
import sys

import torch

from . import (attention, chunk_matmul, collective_matmul,  # noqa: F401
               creation, cuda, flash_attention, fused_adam, fused_epilogue,
               linalg, logic, manipulation, math, pallas, random,
               reduction, sequence)
from .attention import (paged_attention,  # noqa: F401
                        paged_attention_reference, paged_attention_select,
                        paged_attention_supported,
                        register_paged_attention_kernel)
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .creation import *  # noqa: F401,F403
from .linalg import dist, norm  # noqa: F401
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from ..amp import _entered, amp_state
from ..core.dispatch import Symbolic
from ..core.dtype import convert_dtype, get_default_dtype  # noqa: F401
from ..core.tensor import Tensor, wrap

_TORCH_KW = frozenset(("dim", "out", "alpha", "correction", "stable",
                       "sorted", "split_size", "split_size_or_sections",
                       "dim0", "dims", "rounding_mode", "memory_format"))


def _method(fn, torch_form=None, tname=None):
    """``fn`` (a paddle op) as a Tensor method; ``torch_form(args,
    kwargs)`` says when a call is in torch's form, which then runs
    torch's method ``tname`` on the tensor."""
    tfn = getattr(torch.Tensor, tname, None) if tname else None

    def method(self, *args, **kwargs):
        if tfn is not None and (not _TORCH_KW.isdisjoint(kwargs) or (
                torch_form is not None and torch_form(args, kwargs))):
            return wrap(tfn(self, *args, **kwargs))
        if amp_state() is None:
            return fn(self, *args, **kwargs)
        with _entered(None):
            return fn(self, *args, **kwargs)
    method.__name__ = fn.__name__
    method.__doc__ = fn.__doc__
    return method


def _ints_first(args, kwargs):
    return bool(args) and isinstance(args[0], int) and not isinstance(
        args[0], bool)


def _two_ints(args, kwargs):
    return len(args) == 2 and builtins.all(isinstance(a, int)
                                          for a in args)


def _bool_second(args, kwargs):
    return len(args) >= 2 and isinstance(args[1], bool)


def _tensor_first(args, kwargs):
    return bool(args) and isinstance(args[0], torch.Tensor)


def _many(args, kwargs):
    return len(args) > 1


def _from_torch(args, kwargs):
    """``torch.split`` (a Python function) calls ``tensor.split(size,
    dim)`` in torch's form, which no argument tells from paddle's: its
    calls are torch's."""
    return sys._getframe(2).f_globals.get("__name__") == "torch.functional"


def _star_shape(fn):
    """``x.reshape(2, 3)`` and ``x.reshape([2, 3])`` alike."""
    def op(x, *shape, name=None, **kw):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple,
                                                     torch.Size)):
            shape = shape[0]
        return fn(x, shape, **kw)
    op.__name__ = fn.__name__
    op.__doc__ = fn.__doc__
    return op


def _binary(tname):
    tfn = getattr(torch.Tensor, tname)

    def op(self, other):
        if isinstance(other, Symbolic):
            return NotImplemented
        out = tfn(self, other)
        if type(out) is torch.Tensor:
            out.__class__ = Tensor
        return out
    op.__name__ = tname
    return op


def _unary(tname):
    tfn = getattr(torch.Tensor, tname)

    def op(self):
        out = tfn(self)
        if type(out) is torch.Tensor:
            out.__class__ = Tensor
        return out
    op.__name__ = tname
    return op


def _getitem(self, idx):
    out = torch._C.TensorBase.__getitem__(self, idx)
    if type(out) is torch.Tensor:
        out.__class__ = Tensor
    return out


def _method_table():
    """Every paddle Tensor method of the op library: ``{name: (op,
    torch_form)}``, ``torch_form`` None where no call of torch's form
    can reach the name."""
    m, red, man, lg, cre = math, reduction, manipulation, logic, creation
    plain = dict(
        # math
        add=m.add, subtract=m.subtract, multiply=m.multiply,
        divide=m.divide, floor_divide=m.floor_divide, remainder=m.remainder,
        mod=m.remainder, pow=m.pow, matmul=m.matmul, mm=m.mm, bmm=m.bmm,
        dot=m.dot, maximum=m.maximum, minimum=m.minimum, exp=m.exp,
        log=m.log, log2=m.log2, log10=m.log10, log1p=m.log1p, sqrt=m.sqrt,
        rsqrt=m.rsqrt, square=m.square, abs=m.abs, sign=m.sign, neg=m.neg,
        floor=m.floor, ceil=m.ceil, round=m.round, trunc=m.trunc, sin=m.sin,
        cos=m.cos, tan=m.tan, asin=m.asin, acos=m.acos, atan=m.atan,
        sinh=m.sinh, cosh=m.cosh, tanh=m.tanh, erf=m.erf, sigmoid=m.sigmoid,
        reciprocal=m.reciprocal, scale=m.scale, clip=m.clip, lerp=m.lerp,
        cumsum=m.cumsum, cumprod=m.cumprod, isnan=m.isnan, isinf=m.isinf,
        isfinite=m.isfinite, trace=m.trace, kron=m.kron, outer=m.outer,
        inner=m.inner, cross=m.cross, addmm=m.addmm,
        nan_to_num=m.nan_to_num, logaddexp=m.logaddexp,
        # reduction
        mean=red.mean, amax=red.amax, amin=red.amin, prod=red.prod,
        argmax=red.argmax, argmin=red.argmin, all=red.all, any=red.any,
        logsumexp=red.logsumexp, std=red.std, var=red.var,
        median=red.median, nanmean=red.nanmean, nansum=red.nansum,
        count_nonzero=red.count_nonzero,
        # manipulation
        t=man.t, moveaxis=man.moveaxis, swapaxes=man.swapaxes,
        flatten=man.flatten, squeeze=man.squeeze, unsqueeze=man.unsqueeze,
        chunk=man.chunk, unbind=man.unbind, expand_as=man.expand_as,
        broadcast_to=man.broadcast_to, roll=man.roll,
        repeat_interleave=man.repeat_interleave, gather_nd=man.gather_nd,
        take_along_axis=man.take_along_axis,
        put_along_axis=man.put_along_axis, scatter_nd_add=man.scatter_nd_add,
        index_sample=man.index_sample, masked_select=man.masked_select,
        masked_fill=man.masked_fill, where=man.where, nonzero=man.nonzero,
        argsort=man.argsort, topk=man.topk, kthvalue=man.kthvalue,
        unique=man.unique, pad=man.pad, diff=man.diff, one_hot=man.one_hot,
        reshape_=man.reshape_, squeeze_=man.squeeze_,
        unsqueeze_=man.unsqueeze_, scatter_=man.scatter_,
        # logic
        equal=lg.equal, not_equal=lg.not_equal,
        greater_than=lg.greater_than, greater_equal=lg.greater_equal,
        less_than=lg.less_than, less_equal=lg.less_equal,
        logical_and=lg.logical_and, logical_or=lg.logical_or,
        logical_xor=lg.logical_xor, logical_not=lg.logical_not,
        isclose=lg.isclose, allclose=lg.allclose, equal_all=lg.equal_all,
        isin=lg.isin,
        # linalg
        norm=linalg.norm, dist=linalg.dist, cholesky=linalg.cholesky,
        inverse=linalg.inverse, matrix_power=linalg.matrix_power,
        # creation-ish
        tril=cre.tril, triu=cre.triu, diag=cre.diag,
    )
    table = {name: (fn, None) for name, fn in plain.items()}
    table.update(
        sum=(red.sum, _bool_second), max=(red.max, _tensor_first),
        min=(red.min, _tensor_first),
        transpose=(man.transpose, _two_ints),
        reshape=(_star_shape(man.reshape), None),
        expand=(_star_shape(man.expand), None),
        tile=(man.tile, _many), flip=(man.flip, _many),
        split=(man.split, _from_torch), sort=(man.sort, None),
        gather=(man.gather, _ints_first),
        index_select=(man.index_select, _ints_first),
        scatter=(man.scatter, _ints_first),
    )
    return table


def _swapped(fn):
    def op(self, other):
        return fn(other, self)
    op.__name__ = fn.__name__
    return op


def symbolic_methods():
    """The Tensor's methods and operators as paddle ops, for the static
    ``Variable``: each records one node through ``core.dispatch.apply``
    (``x.flatten(1)``, ``x / 2``, ``x @ w``, ``-x``, ``x[0]``, ...)."""
    m, lg, man = math, logic, manipulation
    out = {name: fn for name, (fn, _) in _method_table().items()}
    binary = {"add": m.add, "sub": m.subtract, "mul": m.multiply,
              "truediv": m.divide, "floordiv": m.floor_divide,
              "mod": m.remainder, "pow": m.pow, "matmul": m.matmul,
              "and": lg.bitwise_and, "or": lg.bitwise_or,
              "xor": lg.bitwise_xor}
    for name, fn in binary.items():
        out[f"__{name}__"] = fn
        out[f"__r{name}__"] = _swapped(fn)
    out.update(__eq__=lg.equal, __ne__=lg.not_equal, __lt__=lg.less_than,
               __le__=lg.less_equal, __gt__=lg.greater_than,
               __ge__=lg.greater_equal, __neg__=m.neg, __abs__=m.abs,
               __invert__=lg.bitwise_not, __getitem__=man.getitem,
               astype=man.cast, cast=man.cast)
    return out


def monkey_patch_tensor():
    T = Tensor
    for name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
                 "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
                 "__rfloordiv__", "__mod__", "__rmod__", "__pow__",
                 "__rpow__", "__matmul__", "__rmatmul__", "__eq__", "__ne__",
                 "__lt__", "__le__", "__gt__", "__ge__", "__and__", "__or__",
                 "__xor__", "__rand__", "__ror__", "__rxor__"):
        setattr(T, name, _binary(name))
    for name in ("__neg__", "__abs__", "__invert__", "__pos__"):
        setattr(T, name, _unary(name))
    T.__getitem__ = _getitem
    T.__hash__ = torch.Tensor.__hash__
    for name, (fn, torch_form) in _method_table().items():
        setattr(T, name, _method(fn, torch_form, tname=name if hasattr(
            torch.Tensor, name) else None))


monkey_patch_tensor()
