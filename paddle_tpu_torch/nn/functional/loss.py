"""Losses beside ``cross_entropy`` and ``mse_loss`` (which live in the
package ``__init__``), with the JAX package's formulas:
``nll_loss`` picks along the last axis and weights each row by its
class (the mean is over rows); ``binary_cross_entropy`` clamps the
probabilities at 1e-12 inside the logs; the logits form is the stable
``max(z, 0) - z t + log1p(exp(-|z|))``, scaled by ``t (pw - 1) + 1``
under ``pos_weight``."""
from __future__ import annotations

import torch

from ...core.dispatch import apply

__all__ = ["nll_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits"]


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _nll(logp, lab, *w, reduction):
    loss = -torch.gather(logp, -1, lab.long().unsqueeze(-1)).squeeze(-1)
    if w:
        loss = loss * w[0][lab.long()]
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    args = (input, label) + (() if weight is None else (weight,))
    return apply(_nll, *args, op_name="nll_loss",
                 attrs={"reduction": reduction})


def _l1(a, b, *, reduction):
    return _reduce(torch.abs(a - b), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return apply(_l1, input, label, op_name="l1_loss",
                 attrs={"reduction": reduction})


def _smooth_l1(a, b, *, reduction, delta):
    d = a - b
    ad = torch.abs(d)
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return apply(_smooth_l1, input, label, op_name="smooth_l1_loss",
                 attrs={"reduction": reduction, "delta": float(delta)})


def _bce(p, t, *w, reduction):
    eps = 1e-12
    loss = -(t * torch.log(torch.clamp_min(p, eps))
             + (1 - t) * torch.log(torch.clamp_min(1 - p, eps)))
    if w:
        loss = loss * w[0]
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    args = (input, label) + (() if weight is None else (weight,))
    return apply(_bce, *args, op_name="binary_cross_entropy",
                 attrs={"reduction": reduction})


def _bce_logits(z, t, *extra, reduction, has_weight, has_pos_weight):
    loss = torch.clamp_min(z, 0) - z * t + torch.log1p(torch.exp(-torch.abs(
        z)))
    if has_pos_weight:
        loss = loss * (t * (extra[-1] - 1) + 1)
    if has_weight:
        loss = loss * extra[0]
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    args = [logit, label] + ([weight] if weight is not None else []) + (
        [pos_weight] if pos_weight is not None else [])
    return apply(_bce_logits, *args, op_name="bce_with_logits",
                 attrs={"reduction": reduction,
                        "has_weight": weight is not None,
                        "has_pos_weight": pos_weight is not None})
