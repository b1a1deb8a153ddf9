"""Optimizers (paddle_tpu.optimizer): SGD, Momentum, Adam and AdamW
with f32 master weights, L1/L2 weight decay, gradient clipping (by
value, by norm, by global norm), the row-wise updates of a sparse
embedding gradient (SGD, ``Adam(lazy_mode=True)``), and the
learning-rate schedules of :mod:`.lr`."""
from . import clip, lr, regularizer  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue, clip_grad_norm_)
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
from .regularizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "ClipGradBase",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "L1Decay", "L2Decay", "regularizer"]
