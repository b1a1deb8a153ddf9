"""Pooling (``paddle_tpu.nn.functional`` max/avg pools and the
adaptive pools), on torch's (cuDNN on the card).

``stride`` defaults to the kernel; ``padding`` takes the convolutions'
forms (a max pool pads with -inf, an average pool with zeros).  An
average over a padded window divides by the pixels inside the input
when ``exclusive`` (paddle's default), by the whole window otherwise.
Adaptive pools take the cells ``[floor(i L / n), ceil((i + 1) L / n))``
as paddle_tpu does.  ``ceil_mode`` is torch's.  ``return_mask`` is
ignored where paddle_tpu ignores it and raises where it raises (the
1-D and 3-D adaptive max pools)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply
from .conv import _pads, _torch_pad, _tuple

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pool(a, *, n, kernel, stride, padding, ceil_mode, channels_last,
          average, exclusive):
    if channels_last:
        a = torch.movedim(a, -1, 1)
    pads = _pads(padding, n, a.shape[2:], kernel, stride, (1,) * n)
    sym = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel))
    if not average:
        if sym:
            out = _MAX[n](a, kernel, stride, tuple(lo for lo, _ in pads),
                          ceil_mode=ceil_mode)
        else:
            a = TF.pad(a, _torch_pad(pads), value=float("-inf"))
            out = _MAX[n](a, kernel, stride, 0, ceil_mode=ceil_mode)
    elif sym:
        out = _AVG[n](a, kernel, stride, tuple(lo for lo, _ in pads),
                      ceil_mode=ceil_mode, count_include_pad=not exclusive)
    else:
        padded = TF.pad(a, _torch_pad(pads))
        out = _AVG[n](padded, kernel, stride, 0, ceil_mode=ceil_mode)
        if exclusive:
            ones = TF.pad(torch.ones_like(a[:1, :1]), _torch_pad(pads))
            out = out / _AVG[n](ones, kernel, stride, 0, ceil_mode=ceil_mode)
    return torch.movedim(out, 1, -1) if channels_last else out


def _pool_op(x, kernel_size, stride, padding, n, data_format, ceil_mode,
             average, exclusive=True):
    kernel = _tuple(kernel_size, n)
    return apply(_pool, x, op_name="pool",
                 attrs={"n": n, "kernel": kernel,
                        "stride": kernel if stride is None
                        else _tuple(stride, n),
                        "padding": padding if isinstance(padding, (str, int))
                        else tuple(padding),
                        "ceil_mode": bool(ceil_mode),
                        "channels_last": not data_format.startswith("NC"),
                        "average": average, "exclusive": bool(exclusive)})


def _no_mask(return_mask, what):
    if return_mask:
        raise NotImplementedError(
            f"{what}: return_mask (argmax indices) is not implemented, as "
            f"in paddle_tpu")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _pool_op(x, kernel_size, stride, padding, 1, "NCL", ceil_mode,
                    False)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    return _pool_op(x, kernel_size, stride, padding, 2, data_format,
                    ceil_mode, False)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    return _pool_op(x, kernel_size, stride, padding, 3, data_format,
                    ceil_mode, False)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool_op(x, kernel_size, stride, padding, 1, "NCL", ceil_mode,
                    True, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_op(x, kernel_size, stride, padding, 2, data_format,
                    ceil_mode, True, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_op(x, kernel_size, stride, padding, 3, data_format,
                    ceil_mode, True, exclusive)


_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _adaptive(a, *, kind, n, output_size, channels_last):
    if channels_last:
        a = torch.movedim(a, -1, 1)
    out = _ADAPTIVE[kind, n](a, output_size)
    return torch.movedim(out, 1, -1) if channels_last else out


def _adaptive_op(x, output_size, kind, n, data_format="NC"):
    return apply(_adaptive, x, op_name=f"adaptive_{kind}_pool{n}d",
                 attrs={"kind": kind, "n": n,
                        "output_size": _tuple(output_size, n),
                        "channels_last": not data_format.startswith("NC")})


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_op(x, output_size, "avg", 1)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_op(x, output_size, "avg", 2, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_op(x, output_size, "avg", 3, data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool1d")
    return _adaptive_op(x, output_size, "max", 1)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_op(x, output_size, "max", 2)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool3d")
    return _adaptive_op(x, output_size, "max", 3)
