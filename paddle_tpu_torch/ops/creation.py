"""Tensor creation (``paddle_tpu.ops.creation``).

A new tensor goes to ``device`` (the device ``set_device`` chose, else
the current CUDA device; raising when there is none) as a paddle
Tensor.  ``dtype=None`` is the default float dtype where the JAX
package takes it (``zeros``, ``ones``, ``eye``, ``linspace``); ``full``
and ``arange`` infer it from their values, as there (integers are
int64 here, int32 there).  The ``*_like`` functions follow ``x``'s
device and, unless told otherwise, its dtype.  ``diag``, ``tril``,
``triu`` and ``clone`` are ops of ``x`` (they carry its gradient)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.placement import device as _resolve_device
from ..core.tensor import to_tensor, wrap

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "logspace", "eye", "diag", "diagflat", "tril", "triu", "meshgrid",
           "assign", "clone", "numel", "complex"]


def _dt(dtype, default=None):
    if dtype is None:
        return get_default_dtype() if default is None else default
    return convert_dtype(dtype)


def _shape(shape):
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None, device=None):
    return wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                            device=_resolve_device(device)))


def ones(shape, dtype=None, name=None, device=None):
    return wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                           device=_resolve_device(device)))


def full(shape, fill_value, dtype=None, name=None, device=None):
    return wrap(torch.full(_shape(shape), _scalar(fill_value),
                           dtype=None if dtype is None
                           else convert_dtype(dtype),
                           device=_resolve_device(device)))


def empty(shape, dtype=None, name=None, device=None):
    """Zeros, as in paddle_tpu (never uninitialised memory)."""
    return zeros(shape, dtype, device=device)


def zeros_like(x, dtype=None, name=None):
    return wrap(torch.zeros_like(x, dtype=_dt(dtype, x.dtype)))


def ones_like(x, dtype=None, name=None):
    return wrap(torch.ones_like(x, dtype=_dt(dtype, x.dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return wrap(torch.full_like(x, _scalar(fill_value),
                                dtype=_dt(dtype, x.dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    """``[start, end)`` by ``step`` on ``device``."""
    if end is None:
        start, end = 0, start
    return wrap(torch.arange(_scalar(start), _scalar(end), _scalar(step),
                             dtype=None if dtype is None
                             else convert_dtype(dtype),
                             device=_resolve_device(device)))


def linspace(start, stop, num, dtype=None, name=None, device=None):
    return wrap(torch.linspace(_scalar(start), _scalar(stop), int(num),
                               dtype=_dt(dtype),
                               device=_resolve_device(device)))


def logspace(start, stop, num, base=10.0, dtype=None, name=None,
             device=None):
    return wrap(torch.logspace(_scalar(start), _scalar(stop), int(num),
                               base=base, dtype=_dt(dtype),
                               device=_resolve_device(device)))


def eye(num_rows, num_columns=None, dtype=None, name=None, device=None):
    return wrap(torch.eye(int(num_rows), int(num_columns or num_rows),
                          dtype=_dt(dtype), device=_resolve_device(device)))


def _diag(a, offset, padding_value):
    if a.dim() == 1:
        out = torch.diag(a, offset)
        if padding_value != 0:
            on = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
            out = torch.where(on, out, torch.full_like(out, padding_value))
        return out
    return torch.diagonal(a, offset).clone()


def diag(x, offset=0, padding_value=0, name=None):
    return apply(_diag, x, op_name="diag",
                 attrs={"offset": int(offset),
                        "padding_value": padding_value})


def _diagflat(a, offset):
    return torch.diagflat(a, offset)


def diagflat(x, offset=0, name=None):
    return apply(_diagflat, x, op_name="diagflat",
                 attrs={"offset": int(offset)})


def _tril(a, diagonal):
    return torch.tril(a, diagonal)


def _triu(a, diagonal):
    return torch.triu(a, diagonal)


def tril(x, diagonal=0, name=None):
    return apply(_tril, x, op_name="tril", attrs={"diagonal": int(diagonal)})


def triu(x, diagonal=0, name=None):
    return apply(_triu, x, op_name="triu", attrs={"diagonal": int(diagonal)})


def meshgrid(*args, **kwargs):
    ts = (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
          else args)
    return wrap(tuple(torch.meshgrid(*ts, indexing="ij")))


def assign(x, output=None):
    """A copy of ``x`` (a Tensor, an array or Python data), or ``x``
    written into ``output``."""
    if output is not None:
        return output.set_value(x)
    if isinstance(x, torch.Tensor):
        return wrap(x.detach().clone())
    return to_tensor(x)


def _clone(a):
    return torch.clone(a)


def clone(x, name=None):
    return apply(_clone, x, op_name="clone")


def numel(x, name=None):
    return wrap(torch.tensor(x.numel(), device=x.device))


def _complex(r, i):
    return torch.complex(r, i)


def complex(real, imag, name=None):
    return apply(_complex, real, imag, op_name="complex")
