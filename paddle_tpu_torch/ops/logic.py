"""Comparisons and logical ops (``paddle_tpu.ops.logic``).  They carry
no gradient; ``allclose`` and ``equal_all`` give a 0-d bool Tensor, as
there."""
from __future__ import annotations

import torch

from ..core.dispatch import apply
from ..core.tensor import wrap
from .math import _tensor_pair

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "isclose", "allclose", "equal_all",
           "is_empty", "is_tensor", "in1d", "isin"]


def _cmp(tfn, op_name):
    def impl(a, b):
        return tfn(*_tensor_pair(a, b))

    def op(x, y, name=None):
        return apply(impl, x, y, op_name=op_name)
    op.__name__ = op_name
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")
logical_and = _cmp(torch.logical_and, "logical_and")
logical_or = _cmp(torch.logical_or, "logical_or")
logical_xor = _cmp(torch.logical_xor, "logical_xor")
bitwise_and = _cmp(torch.bitwise_and, "bitwise_and")
bitwise_or = _cmp(torch.bitwise_or, "bitwise_or")
bitwise_xor = _cmp(torch.bitwise_xor, "bitwise_xor")


def logical_not(x, name=None):
    return apply(torch.logical_not, x, op_name="logical_not")


def bitwise_not(x, name=None):
    return apply(torch.bitwise_not, x, op_name="bitwise_not")


def _isclose(a, b, *, rtol, atol, equal_nan):
    return torch.isclose(*_tensor_pair(a, b), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(_isclose, x, y, op_name="isclose",
                 attrs={"rtol": rtol, "atol": atol, "equal_nan": equal_nan})


def _allclose(a, b, *, rtol, atol, equal_nan):
    return torch.all(_isclose(a, b, rtol=rtol, atol=atol,
                              equal_nan=equal_nan))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(_allclose, x, y, op_name="allclose",
                 attrs={"rtol": rtol, "atol": atol, "equal_nan": equal_nan})


def _equal_all(a, b):
    if a.shape != b.shape:
        return torch.tensor(False, device=a.device)
    return torch.all(torch.eq(a, b))


def equal_all(x, y, name=None):
    return apply(_equal_all, x, y, op_name="equal_all")


def is_empty(x, name=None):
    return wrap(torch.tensor(x.numel() == 0, device=x.device))


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def in1d(x, test, name=None):
    return apply(torch.isin, x, test, op_name="isin")


isin = in1d
