"""static.nn: static-graph layer helpers (``paddle_tpu/static/nn.py``).

``fc`` creates its own weights on ``get_device()`` (XavierNormal
``[in, size]``, zero bias, drawn from ``core.rng.generator``); it takes
``weight_attr`` and ``bias_attr`` and ignores them, as paddle_tpu's
does.  ``batch_norm`` normalises with the batch's statistics and fresh
affine parameters (ones and zeros), as paddle_tpu's static shim: running
statistics are the dygraph layer's.  ``cond``, ``case``, ``switch_case``
and ``while_loop`` are :mod:`..ops.control_flow`'s, which record one
node into the Program when a predicate, index or loop variable is a
Variable."""
from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.placement import device as _resolve_device
from ..core.tensor import Parameter
from ..nn import functional as F
from ..ops.control_flow import case, cond, switch_case, while_loop  # noqa

__all__ = ["fc", "batch_norm", "cond", "case", "switch_case", "while_loop"]


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """``activation(flatten(x) @ w + b)`` with fresh parameters."""
    dev = _resolve_device(None)
    in_features = math.prod(x.shape[num_flatten_dims:])
    std = math.sqrt(2.0 / (in_features + size))
    w = Parameter(torch.randn(
        (in_features, size), device=dev, generator=rng.generator(dev)) * std)
    b = Parameter(torch.zeros(size, device=dev))
    # trailing dims are concrete; at most the leading dynamic dim stays -1
    flat = (x.reshape(list(x.shape[:num_flatten_dims]) + [in_features])
            if len(x.shape) > num_flatten_dims + 1 else x)
    out = F.linear(flat, w, b)
    if activation is not None:
        out = getattr(F, activation)(out)
    return out


def batch_norm(input, is_test=False, momentum=0.9, epsilon=1e-5,
               data_layout="NCHW", **kwargs):
    """Batch-statistics normalisation with fresh affine parameters."""
    dev = _resolve_device(None)
    c = input.shape[1 if data_layout.startswith("NC") else -1]
    w = Parameter(torch.ones(c, device=dev))
    b = Parameter(torch.zeros(c, device=dev))
    return F.batch_norm(input, None, None, w, b, training=not is_test,
                        momentum=momentum, epsilon=epsilon,
                        data_format=data_layout)
