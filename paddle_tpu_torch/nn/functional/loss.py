"""Losses beside ``cross_entropy`` and ``mse_loss`` (which live in the
package ``__init__``), with the JAX package's formulas:
``nll_loss`` picks along the last axis and weights each row by its
class (the mean is over rows); ``binary_cross_entropy`` clamps the
probabilities at 1e-12 inside the logs; the logits form is the stable
``max(z, 0) - z t + log1p(exp(-|z|))``, scaled by ``t (pw - 1) + 1``
under ``pos_weight``.

The rest follow the JAX package's formulas too: ``kl_div`` clamps the
target at 1e-12 inside its log (``batchmean`` divides by the batch);
``ctc_loss`` takes ``[T, B, C]`` logits (normalised by a log-softmax
first, as optax does) and its ``mean`` is the plain mean of the
per-sequence losses (``norm_by_times`` is ignored, as in paddle_tpu);
``hsigmoid_loss``'s default tree is the complete binary tree over the
classes, whose paths are built on the host once and indexed on the
labels' device."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import apply

__all__ = ["nll_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "sigmoid_focal_loss", "ctc_loss",
           "square_error_cost", "log_loss", "dice_loss", "npair_loss",
           "hsigmoid_loss"]


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


def _kl_div(logp, t, *, reduction):
    loss = t * (torch.log(torch.clamp_min(t, 1e-12)) - logp)
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log label - input)``; ``input`` is log-probabilities."""
    return apply(_kl_div, input, label, op_name="kl_div",
                 attrs={"reduction": reduction})


def _margin_ranking(a, b, t, *, margin, reduction):
    return _reduce(torch.clamp_min(-t * (a - b) + margin, 0.0), reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply(_margin_ranking, input, other, label,
                 op_name="margin_ranking_loss",
                 attrs={"margin": float(margin), "reduction": reduction})


def _hinge_embedding(a, t, *, margin, reduction):
    return _reduce(torch.where(t == 1, a, torch.clamp_min(margin - a, 0.0)),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return apply(_hinge_embedding, input, label,
                 op_name="hinge_embedding_loss",
                 attrs={"margin": float(margin), "reduction": reduction})


def _cosine_embedding(a, b, t, *, margin, reduction):
    cs = (a * b).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), 1e-12)
    return _reduce(torch.where(t == 1, 1 - cs,
                               torch.clamp_min(cs - margin, 0.0)), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    return apply(_cosine_embedding, input1, input2, label,
                 op_name="cosine_embedding_loss",
                 attrs={"margin": float(margin), "reduction": reduction})


def _sigmoid_focal(z, t, *n, alpha, gamma, reduction):
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0) - z * t + torch.log1p(torch.exp(-torch.abs(z)))
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    loss = a_t * (1 - p_t) ** gamma * ce
    if n:
        loss = loss / n[0]
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    args = (logit, label) + (() if normalizer is None else (normalizer,))
    return apply(_sigmoid_focal, *args, op_name="sigmoid_focal_loss",
                 attrs={"alpha": float(alpha), "gamma": float(gamma),
                        "reduction": reduction})


def _ctc(logits, labels, il, ll, *, blank, reduction):
    per_seq = TF.ctc_loss(torch.log_softmax(logits, -1), labels.long(),
                          il.long(), ll.long(), blank=blank,
                          reduction="none")
    return _reduce(per_seq, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``[T, B, C]`` logits, ``[B, L]`` padded labels and the
    two length vectors; ``mean`` averages the per-sequence losses."""
    return apply(_ctc, log_probs, labels, input_lengths, label_lengths,
                 op_name="ctc_loss",
                 attrs={"blank": int(blank), "reduction": reduction})


def _square_error(a, b):
    return (a - b) ** 2


def square_error_cost(input, label, name=None):
    return apply(_square_error, input, label, op_name="square_error_cost")


def _log_loss(p, y, *, epsilon):
    return -y * torch.log(p + epsilon) - (1.0 - y) * torch.log(
        1.0 - p + epsilon)


def log_loss(input, label, epsilon=1e-4, name=None):
    """Binary cross entropy on probabilities, unreduced."""
    return apply(_log_loss, input, label, op_name="log_loss",
                 attrs={"epsilon": float(epsilon)})


def _dice(p, y, *, epsilon):
    yf = TF.one_hot(y.squeeze(-1).long(), p.shape[-1]).to(p.dtype)
    red = tuple(range(1, p.dim()))
    inter = (p * yf).sum(red)
    union = p.sum(red) + yf.sum(red)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - the dice coefficient of ``[N, ..., C]`` probabilities against
    ``[N, ..., 1]`` integer labels, averaged over N."""
    return apply(_dice, input, label, op_name="dice_loss",
                 attrs={"epsilon": float(epsilon)})


def _npair(a, p, y, *, l2_reg):
    sim = a @ p.t()
    lab = (y[:, None] == y[None, :]).to(a.dtype)
    lab = lab / torch.clamp_min(lab.sum(1, keepdim=True), 1.0)
    ce = -(lab * torch.log_softmax(sim, 1)).sum(1).mean()
    reg = l2_reg * ((a ** 2).sum(1) + (p ** 2).sum(1)).mean() * 0.25
    return ce + reg


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Sohn's N-pair loss: the soft-label cross entropy of
    anchor . positive^T over same-label pairs, plus an L2 term."""
    return apply(_npair, anchor, positive, labels, op_name="npair_loss",
                 attrs={"l2_reg": float(l2_reg)})


def _default_tree(num_classes):
    """The complete binary tree's paths: ``[num_classes, depth]`` node
    ids (-1 past a path's end) and right-child codes."""
    depth = max(int(np.ceil(np.log2(max(num_classes, 2)))), 1)
    tbl = np.full((num_classes, depth), -1, np.int64)
    code = np.zeros((num_classes, depth), np.float32)
    for c in range(num_classes):
        node, path = c + num_classes - 1, []
        while node > 0:
            parent = (node - 1) // 2
            path.append((parent, float(node == 2 * parent + 2)))
            node = parent
        for d, (pn, bit) in enumerate(reversed(path)):
            tbl[c, d], code[c, d] = pn, bit
    return tbl, code


def _hsigmoid(x, y, tbl, code, w, *b):
    valid = tbl >= 0
    t = torch.clamp_min(tbl, 0).long()
    logits = torch.einsum("nd,nld->nl", x, w[t])
    if b:
        logits = logits + b[0][t]
    bce = -(code * TF.logsigmoid(logits) + (1.0 - code) * TF.logsigmoid(
        -logits))
    return (bce * valid).sum(1, keepdim=True)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """The hierarchical sigmoid loss, ``[N, 1]``: the binary cross
    entropy of each node on the label's path (the default complete
    binary tree, or ``path_table``/``path_code`` ``[N, L]`` padded with
    -1)."""
    if path_table is None:
        tbl, code = _default_tree(num_classes)
        rows = torch.reshape(label, (-1,)).long()
        path_table = torch.as_tensor(tbl, device=rows.device)[rows]
        path_code = torch.as_tensor(code, device=rows.device)[rows].to(
            input.dtype)
    elif path_code is None:
        raise ValueError(
            "hsigmoid_loss: a custom path_table requires path_code")
    args = (input, label, path_table, path_code, weight) + (
        () if bias is None else (bias,))
    return apply(_hsigmoid, *args, op_name="hsigmoid_loss")
