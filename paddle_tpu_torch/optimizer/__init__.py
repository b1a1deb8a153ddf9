"""Optimizers (paddle_tpu.optimizer): SGD, Momentum, Adam and AdamW
with f32 master weights, L1/L2 weight decay, global-norm gradient
clipping, and the learning-rate schedules of :mod:`.lr`."""
from . import clip, lr, regularizer  # noqa: F401
from .clip import ClipGradBase, ClipGradByGlobalNorm  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
from .regularizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "ClipGradBase",
           "ClipGradByGlobalNorm", "L1Decay", "L2Decay", "regularizer"]
