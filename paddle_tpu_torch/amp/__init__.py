"""Automatic mixed precision (paddle_tpu.amp): ``decorate`` at level O2.

O2 casts the model's parameters to the low-precision type and turns on
the optimizers' f32 master weights, so the forward and backward run in
bf16 while the update runs in f32.  ``auto_cast`` (O1) and
``GradScaler`` are not ported yet (ROADMAP A3)."""
from __future__ import annotations

import torch

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Cast ``models`` to ``dtype`` and enable the ``optimizers``' master
    weights (unless ``master_weight`` is False).  Returns what it was
    given: ``models`` alone, or ``(models, optimizers)``."""
    if level != "O2":
        raise NotImplementedError(f"amp.decorate level {level!r}: only O2 "
                                  "is ported")
    if save_dtype is not None:
        raise NotImplementedError("amp.decorate: save_dtype is not ported")
    if dtype not in _DTYPES:
        raise ValueError(f"amp.decorate: dtype {dtype!r} not in "
                         f"{sorted(_DTYPES)}")
    dt = _DTYPES[dtype]
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    for m in ms:
        if m is not None:
            m.to(dtype=dt)
            m._amp_dtype = dt
    if optimizers is None:
        return models
    single_opt = not isinstance(optimizers, (list, tuple))
    opts = [optimizers] if single_opt else list(optimizers)
    for o in opts:
        o._multi_precision = True if master_weight is None else bool(
            master_weight)
    return models, optimizers
