"""Weight-decay regularizers (``paddle_tpu.optimizer.regularizer``):
added to the gradients before the update.  An optimizer's
``weight_decay`` may be one of these (a float is an ``L2Decay``); a
parameter's own, from ``ParamAttr(regularizer=...)``, wins over it."""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    coeff = 0.0

    def __call__(self, param, grad):
        """The regularized gradient of one parameter."""
        return self._apply([param], [grad])[0]

    def _apply(self, params, grads):
        """The regularized gradients of a list, as one multi-tensor
        op."""
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """``grad + coeff * param``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _apply(self, params, grads):
        return torch._foreach_add(
            grads, [p.to(g.dtype) for p, g in zip(params, grads)],
            alpha=self.coeff)


class L1Decay(WeightDecayRegularizer):
    """``grad + coeff * sign(param)``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _apply(self, params, grads):
        return torch._foreach_add(
            grads, [torch.sign(p).to(g.dtype) for p, g in zip(params, grads)],
            alpha=self.coeff)
