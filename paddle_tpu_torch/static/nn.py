"""static.nn: static-graph layer helpers (``paddle_tpu/static/nn.py``).

``fc`` creates its own weights on ``get_device()`` (XavierNormal
``[in, size]``, zero bias, drawn from ``core.rng.generator``); it takes
``weight_attr`` and ``bias_attr`` and ignores them, as paddle_tpu's
does."""
from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.placement import device as _resolve_device
from ..nn import functional as F

__all__ = ["fc"]


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """``activation(flatten(x) @ w + b)`` with fresh parameters."""
    dev = _resolve_device(None)
    in_features = math.prod(x.shape[num_flatten_dims:])
    std = math.sqrt(2.0 / (in_features + size))
    w = torch.nn.Parameter(torch.randn(
        (in_features, size), device=dev, generator=rng.generator(dev)) * std)
    b = torch.nn.Parameter(torch.zeros(size, device=dev))
    # trailing dims are concrete; at most the leading dynamic dim stays -1
    flat = (x.reshape(list(x.shape[:num_flatten_dims]) + [in_features])
            if len(x.shape) > num_flatten_dims + 1 else x)
    out = F.linear(flat, w, b)
    if activation is not None:
        out = getattr(F, activation)(out)
    return out
