"""Optimizers (paddle_tpu.optimizer): Adam and AdamW with f32 master
weights, global-norm gradient clipping, and the learning-rate
schedules of :mod:`.lr`."""
from . import clip, lr  # noqa: F401
from .clip import ClipGradBase, ClipGradByGlobalNorm  # noqa: F401
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW", "ClipGradBase",
           "ClipGradByGlobalNorm"]
