"""Reductions (``paddle_tpu.ops.reduction``).

``axis`` is None (every dim), an int or a list of ints, as there.
``argmax``/``argmin`` give int64 (paddle_tpu without x64 gives int32);
``median`` averages the two middle values of an even count, as
``jnp.median`` does; ``mean`` of an integer tensor is a float."""
from __future__ import annotations

import torch

from ..core.dispatch import apply
from ..core.dtype import convert_dtype, get_default_dtype

__all__ = ["sum", "mean", "max", "min", "amax", "amin", "prod", "argmax",
           "argmin", "all", "any", "logsumexp", "std", "var", "median",
           "nanmean", "nansum", "count_nonzero"]


def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a, axis):
    """``axis`` as the tuple of dims it reduces (all for None)."""
    if axis is None:
        return tuple(range(a.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _float(a):
    return a if a.is_floating_point() or a.is_complex() else a.to(
        get_default_dtype())


def _sum(a, *, axis, dtype, keepdim):
    d = None if dtype is None else convert_dtype(dtype)
    return torch.sum(a, _dims(a, axis), keepdim=keepdim, dtype=d)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return apply(_sum, x, op_name="sum",
                 attrs={"axis": _norm_axis(axis), "dtype": dtype,
                        "keepdim": bool(keepdim)})


def _mean(a, *, axis, keepdim):
    return torch.mean(_float(a), _dims(a, axis), keepdim=keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    return apply(_mean, x, op_name="mean",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def _max(a, *, axis, keepdim):
    return torch.amax(a, _dims(a, axis), keepdim=keepdim)


def _min(a, *, axis, keepdim):
    return torch.amin(a, _dims(a, axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):
    return apply(_max, x, op_name="max",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def min(x, axis=None, keepdim=False, name=None):
    return apply(_min, x, op_name="min",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def _prod(a, *, axis, keepdim, dtype):
    d = None if dtype is None else convert_dtype(dtype)
    dims = _dims(a, axis)
    dims = tuple(sorted(x % a.dim() for x in dims)) if a.dim() else ()
    keep = [i for i in range(a.dim()) if i not in dims]
    flat = a.permute(*keep, *dims).reshape(*[a.shape[i] for i in keep], -1)
    out = torch.prod(flat, -1, dtype=d)
    if keepdim:
        out = out.reshape([1 if i in dims else a.shape[i]
                           for i in range(a.dim())])
    return out


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    return apply(_prod, x, op_name="prod",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim),
                        "dtype": dtype})


def _argmax(a, *, axis, keepdim):
    if axis is None:
        return torch.argmax(a.reshape(-1))
    return torch.argmax(a, axis, keepdim=keepdim)


def _argmin(a, *, axis, keepdim):
    if axis is None:
        return torch.argmin(a.reshape(-1))
    return torch.argmin(a, axis, keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply(_argmax, x, op_name="argmax",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply(_argmin, x, op_name="argmin",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def _all(a, *, axis, keepdim):
    return torch.all(a, _dims(a, axis), keepdim=keepdim)


def _any(a, *, axis, keepdim):
    return torch.any(a, _dims(a, axis), keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):
    return apply(_all, x, op_name="all",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def any(x, axis=None, keepdim=False, name=None):
    return apply(_any, x, op_name="any",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def _logsumexp(a, *, axis, keepdim):
    return torch.logsumexp(a, _dims(a, axis), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply(_logsumexp, x, op_name="logsumexp",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def _std(a, *, axis, unbiased, keepdim):
    return torch.std(_float(a), _dims(a, axis), correction=int(unbiased),
                     keepdim=keepdim)


def _var(a, *, axis, unbiased, keepdim):
    return torch.var(_float(a), _dims(a, axis), correction=int(unbiased),
                     keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(_std, x, op_name="std",
                 attrs={"axis": _norm_axis(axis), "unbiased": bool(unbiased),
                        "keepdim": bool(keepdim)})


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(_var, x, op_name="var",
                 attrs={"axis": _norm_axis(axis), "unbiased": bool(unbiased),
                        "keepdim": bool(keepdim)})


def _median(a, *, axis, keepdim):
    a = _float(a)
    if axis is None:
        out = torch.quantile(a.reshape(-1), 0.5)
        return out.reshape([1] * a.dim()) if keepdim else out
    if isinstance(axis, tuple):
        dims = tuple(sorted(x % a.dim() for x in axis))
        keep = [i for i in range(a.dim()) if i not in dims]
        flat = a.permute(*keep, *dims).reshape(*[a.shape[i] for i in keep],
                                               -1)
        out = torch.quantile(flat, 0.5, dim=-1)
        if keepdim:
            out = out.reshape([1 if i in dims else a.shape[i]
                               for i in range(a.dim())])
        return out
    return torch.quantile(a, 0.5, dim=axis, keepdim=keepdim)


def median(x, axis=None, keepdim=False, name=None):
    return apply(_median, x, op_name="median",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def _nanmean(a, *, axis, keepdim):
    return torch.nanmean(a, _dims(a, axis), keepdim=keepdim)


def _nansum(a, *, axis, dtype, keepdim):
    d = None if dtype is None else convert_dtype(dtype)
    return torch.nansum(a, _dims(a, axis), keepdim=keepdim, dtype=d)


def nanmean(x, axis=None, keepdim=False, name=None):
    return apply(_nanmean, x, op_name="nanmean",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return apply(_nansum, x, op_name="nansum",
                 attrs={"axis": _norm_axis(axis), "dtype": dtype,
                        "keepdim": bool(keepdim)})


def _count_nonzero(a, *, axis, keepdim):
    out = torch.count_nonzero(a, _dims(a, axis))
    if keepdim:
        dims = {d % a.dim() for d in _dims(a, axis)}
        out = out.reshape([1 if i in dims else a.shape[i]
                           for i in range(a.dim())])
    return out


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return apply(_count_nonzero, x, op_name="count_nonzero",
                 attrs={"axis": _norm_axis(axis), "keepdim": bool(keepdim)})
