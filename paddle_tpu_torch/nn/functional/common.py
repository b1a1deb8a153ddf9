"""The channel and alpha dropouts, ``bilinear``, ``cosine_similarity``,
``diag_embed`` and ``label_smooth`` (the rest of paddle_tpu's
``nn.functional`` beside the vision functions of :mod:`.vision`).

``dropout2d``/``dropout3d`` drop whole channels through ``F.dropout``'s
16-bit rule; ``alpha_dropout`` keeps each value with probability
``1 - p`` from the device's ``core.rng`` generator and moves the dropped
ones to SELU's negative saturation, with the affine correction that
keeps a unit normal input's mean and variance.  The streams are not the
JAX package's, so these are held by statistics, not by values.
"""
from __future__ import annotations

import torch

from ...core import rng
from ...core.dispatch import apply

__all__ = ["dropout2d", "dropout3d", "alpha_dropout", "bilinear",
           "cosine_similarity", "diag_embed", "label_smooth"]


def _channel_dropout(x, p, training, data_format, spatial):
    from . import dropout
    channel = 1 if data_format.startswith("NC") else spatial + 1
    return dropout(x, p, axis=[0, channel], training=training)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Zero whole ``[H, W]`` channels with probability ``p``."""
    return _channel_dropout(x, p, training, data_format, 2)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Zero whole ``[D, H, W]`` channels with probability ``p``."""
    return _channel_dropout(x, p, training, data_format, 3)


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _alpha_dropout(a, *, p):
    neg = -_SELU_ALPHA * _SELU_SCALE
    q = 1.0 - p
    keep = torch.rand(a.shape, device=a.device,
                      generator=rng.generator(a.device)) < q
    A = (q + neg ** 2 * q * p) ** -0.5
    B = -A * p * neg
    return A * torch.where(keep, a, torch.full_like(a, neg)) + B


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    return apply(_alpha_dropout, x, op_name="alpha_dropout",
                 attrs={"p": float(p)})


def _bilinear(a, b, w):
    return torch.einsum("bi,oij,bj->bo", a, w, b)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] . weight[o] . x2[b] (+ bias[o])``; ``weight``
    is ``[out, in1, in2]``."""
    out = apply(_bilinear, x1, x2, weight, op_name="bilinear")
    return out if bias is None else out + bias


def _cosine_similarity(a, b, *, axis, eps):
    dot = (a * b).sum(axis)
    return dot / torch.clamp_min(
        torch.sqrt((a * a).sum(axis)) * torch.sqrt((b * b).sum(axis)), eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return apply(_cosine_similarity, x1, x2, op_name="cosine_similarity",
                 attrs={"axis": int(axis), "eps": float(eps)})


def _diag_embed(a):
    return torch.diag_embed(a)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """``[..., n]`` -> ``[..., n, n]`` with ``x`` on the diagonal.  Only
    the defaults are taken: paddle_tpu ignores ``offset``, ``dim1`` and
    ``dim2``, so other values raise here rather than give its result."""
    if (offset, dim1, dim2) != (0, -2, -1):
        raise NotImplementedError(
            f"diag_embed(offset={offset}, dim1={dim1}, dim2={dim2}): only "
            "the main diagonal over the last two dims is supported")
    return apply(_diag_embed, x, op_name="diag_embed")


def _label_smooth(t, *prior, epsilon):
    if prior:
        return (1 - epsilon) * t + epsilon * prior[0]
    return (1 - epsilon) * t + epsilon / t.shape[-1]


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon * prior``, the prior uniform
    over the last axis unless ``prior_dist`` gives it."""
    args = (label,) + (() if prior_dist is None else (prior_dist,))
    return apply(_label_smooth, *args, op_name="label_smooth",
                 attrs={"epsilon": float(epsilon)})
