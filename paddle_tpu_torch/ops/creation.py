"""Tensor creation (the part of ``paddle_tpu.ops.creation`` the static
BERT path uses)."""
from __future__ import annotations

import torch

from ..core.placement import device as _resolve_device
from ..core.dtype import convert_dtype

__all__ = ["arange"]


def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    """``[start, end)`` by ``step`` on ``device`` (the device
    ``set_device`` chose, else the current CUDA device).  Inside a
    static program it is a constant, as in paddle_tpu."""
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step,
                        dtype=None if dtype is None else convert_dtype(dtype),
                        device=_resolve_device(device))
