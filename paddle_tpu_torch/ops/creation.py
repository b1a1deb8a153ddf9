"""Tensor creation (``paddle_tpu.ops.creation``: ``zeros`` and its
siblings, and ``arange``).

A new tensor goes to ``device`` (the device ``set_device`` chose, else
the current CUDA device); ``dtype=None`` is float32 where the JAX
package takes its default dtype (``full`` and ``arange`` infer it from
their values, as there).  The ``*_like`` functions follow ``x``'s
device and, unless told otherwise, its dtype.  Inside a static program
the results are constants, as in paddle_tpu."""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from ..core.placement import device as _resolve_device

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange"]


def _dt(dtype, default=torch.float32):
    return default if dtype is None else convert_dtype(dtype)


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def zeros(shape, dtype=None, name=None, device=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=_resolve_device(device))


def ones(shape, dtype=None, name=None, device=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=_resolve_device(device))


def full(shape, fill_value, dtype=None, name=None, device=None):
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype, None),
                      device=_resolve_device(device))


def empty(shape, dtype=None, name=None, device=None):
    """Zeros, as in paddle_tpu (never uninitialised memory)."""
    return zeros(shape, dtype, device=device)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_dt(dtype, x.dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=_dt(dtype, x.dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, fill_value, dtype=_dt(dtype, x.dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    """``[start, end)`` by ``step`` on ``device``."""
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step,
                        dtype=None if dtype is None else convert_dtype(dtype),
                        device=_resolve_device(device))
