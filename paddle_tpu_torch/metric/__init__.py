"""Metrics (``paddle_tpu.metric``): ``Metric``, ``Accuracy`` (top-k),
``Precision``, ``Recall``, ``Auc`` (histogram-bucketed ROC) and the
functional ``accuracy``.

The classes keep their counts on the host in numpy, as paddle_tpu's do:
``update`` takes tensors (read back from the card) or arrays.
``accuracy`` is one paddle op on the tensors' device."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.tensor import Tensor, to_tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return torch.Tensor.numpy(x.detach().cpu())
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-processing of (pred, label) before update."""
        return args


class Accuracy(Metric):
    """Top-k accuracy: ``compute`` gives the ``[N, maxk]`` hits of the
    ``maxk`` best scores (a Tensor on the prediction's device),
    ``update`` counts them."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np, label_np = _np(pred), _np(label)
        idx = np.argsort(-pred_np, axis=-1, kind="stable")[..., :self.maxk]
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        correct = (idx == label_np[..., None]).astype(np.float32)
        place = pred.device if isinstance(pred, torch.Tensor) else "cpu"
        return to_tensor(correct, place=place)

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim > 0 else 1
        res = [float(c[..., :k].sum()) / max(num, 1) for k in self.topk]
        self.total = [t + float(c[..., :k].sum())
                      for t, k in zip(self.total, self.topk)]
        self.count = [cnt + num for cnt in self.count]
        return res[0] if len(res) == 1 else res

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of ``preds > 0.5`` against 0/1 ``labels``."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of ``preds > 0.5`` against 0/1 ``labels``."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC from ``num_thresholds + 1`` histogram buckets of the
    positive-class score (column 1 of a ``[N, 2]`` prediction)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        lab = _np(labels).reshape(-1).astype(bool)
        buckets = np.minimum((p * self.num_thresholds).astype(np.int64),
                             self.num_thresholds)
        n = self.num_thresholds + 1
        self._stat_pos += np.bincount(buckets[lab], minlength=n)
        self._stat_neg += np.bincount(buckets[~lab], minlength=n)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)

    def name(self):
        return self._name


def _accuracy(pred, label, *, k):
    top = torch.argsort(torch.neg(pred), dim=-1, stable=True)[..., :k]
    lab = (label if label.dim() == pred.dim() - 1
           else torch.squeeze(label, -1))
    hit = torch.any(torch.eq(top, torch.unsqueeze(lab, -1)), dim=-1)
    return torch.mean(hit.float())


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` best scores."""
    return apply(_accuracy, input, label, op_name="accuracy",
                 attrs={"k": int(k)})
