"""Optimizers (paddle_tpu.optimizer): SGD, Momentum, Adam and AdamW
with f32 master weights, the tail (Adamax, Adagrad, Adadelta, RMSProp,
Lamb, LarsMomentum, Ftrl, Dpsgd, ProximalGD, ProximalAdagrad,
DecayedAdagrad), the parameter averages of :mod:`.extras` (EMA,
ModelAverage, Lookahead), L1/L2 weight decay, gradient clipping (by
value, by norm, by global norm), the row-wise updates of a sparse
embedding gradient (SGD, ``Adam(lazy_mode=True)``), and the
learning-rate schedules of :mod:`.lr`."""
from . import clip, extras, lr, regularizer  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue, clip_grad_norm_)
from .extras import (ExponentialMovingAverage, Lookahead,  # noqa: F401
                     LookaheadOptimizer, ModelAverage)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, DecayedAdagrad, Dpsgd, Ftrl, Lamb,
                        LarsMomentum, Momentum, Optimizer, ProximalAdagrad,
                        ProximalGD, RMSProp)
from .regularizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "Ftrl",
           "Dpsgd", "ProximalGD", "ProximalAdagrad", "DecayedAdagrad",
           "ExponentialMovingAverage", "ModelAverage", "LookaheadOptimizer",
           "Lookahead", "ClipGradBase", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "L1Decay", "L2Decay", "regularizer"]
