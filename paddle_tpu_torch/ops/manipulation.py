"""Shape manipulation (the part of ``paddle_tpu.ops.manipulation`` the
ported models use)."""
from __future__ import annotations

from ..core.dispatch import apply

__all__ = ["transpose"]


def _transpose(x, perm):
    return x.permute(perm)


def transpose(x, perm, name=None):
    """``x`` with its dims in the order ``perm``: a view, so autograd
    carries the gradient to ``x``."""
    return apply(_transpose, x, op_name="transpose",
                 attrs={"perm": tuple(int(p) for p in perm)})
