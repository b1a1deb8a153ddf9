"""Fused Adam: one pass over each (p, g, m, v) that reads them once and
writes (p', m', v') once (the counterpart of
``paddle_tpu/ops/pallas/fused_adam.py``).

Two versions of one update, chosen by where the tensors lie:

- the plain PyTorch version :func:`fused_adam_reference_` (the TPU
  kernel's arithmetic in f32: bias correction ``1 - exp(step * log
  beta)``, ``lr`` and ``step`` as tensors): the CPU path and the oracle
  the CUDA kernel is held to;
- the hand-written CUDA kernel of :mod:`.cuda.fused_adam` (K3): one
  launch over a device table of every quartet, for CUDA tensors.

Both take the anomaly sentry's optional ``skip`` flag (an int32 scalar
tensor, read where it lies): when it is not 0 the step writes nothing,
so p, m and v stay bitwise as they were.  The kernel returns before it
writes; the plain version selects the old values elementwise
(``torch.where``), so neither reads the flag on the host.

:func:`fused_update_for` is the static Executor's opt-in, with
paddle_tpu's eligibility: it returns a :class:`FusedAdam` over the given
tensors only for a plain f32 ``Adam`` whose semantics the kernel
reproduces (no grad clip, no weight decay, no multi-precision master
weights), else None.  :func:`fused_adam_update` is paddle_tpu's
single-tensor entry.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .cuda import fused_adam as _cuda

__all__ = ["fused_adam_supported", "fused_adam_update",
           "fused_adam_reference_", "fused_adam_eligible",
           "fused_update_for", "FusedAdam"]


def fused_adam_supported(shape, dtype) -> bool:
    """f32 parameters only: a bf16 parameter would take the
    master-weight path the kernel does not carry."""
    return dtype == torch.float32


def fused_adam_reference_(params, grads, ms, vs, lr, step, *,
                          beta1=0.9, beta2=0.999, eps=1e-8,
                          skip=None) -> None:
    """Plain version of the kernel, in place over lists of f32 tensors;
    ``lr`` and ``step`` are f32 scalar tensors, ``skip`` None or an
    int32 scalar tensor (not 0: every tensor keeps its value)."""
    bc1 = 1.0 - torch.exp(step * math.log(beta1))
    bc2 = 1.0 - torch.exp(step * math.log(beta2))
    for p, g, m, v in zip(params, grads, ms, vs):
        m2 = beta1 * m + (1.0 - beta1) * g
        v2 = beta2 * v + (1.0 - beta2) * g * g
        p2 = p - lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        if skip is not None:
            keep = skip != 0
            m2, v2, p2 = (torch.where(keep, m, m2), torch.where(keep, v, v2),
                          torch.where(keep, p, p2))
        m.copy_(m2)
        v.copy_(v2)
        p.copy_(p2)


class FusedAdam:
    """Adam over a fixed list of (p, g, m, v), updated in place by one
    call a step: one kernel launch for CUDA tensors (the device table is
    built here, once), the plain version otherwise."""

    def __init__(self, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor], beta1=0.9, beta2=0.999,
                 eps=1e-8):
        self.lists = (list(params), list(grads), list(ms), list(vs))
        self.kw = dict(beta1=float(beta1), beta2=float(beta2),
                       eps=float(eps))
        self.table = (_cuda.AdamTable(*self.lists)
                      if self.lists[0] and self.lists[0][0].is_cuda
                      else None)

    @torch.no_grad()
    def __call__(self, lr: torch.Tensor, step: torch.Tensor,
                 skip: Optional[torch.Tensor] = None) -> None:
        if self.table is not None:
            _cuda.fused_adam(self.table, lr, step, skip=skip, **self.kw)
        else:
            fused_adam_reference_(*self.lists, lr, step, skip=skip,
                                  **self.kw)


def fused_adam_update(p, g, m, v, lr, step, *, beta1=0.9, beta2=0.999,
                      eps=1e-8):
    """One Adam step of one tensor -> new ``(p, m, v)`` (the inputs are
    left as they are); ``lr`` and ``step`` are numbers or scalar
    tensors."""
    p, m, v = p.clone(), m.clone(), v.clone()
    as_t = lambda s: torch.as_tensor(s, dtype=torch.float32,  # noqa: E731
                                     device=p.device).reshape(())
    FusedAdam([p], [g.contiguous()], [m], [v], beta1, beta2, eps)(
        as_t(lr), as_t(step))
    return p, m, v


def fused_adam_eligible(opt, params: Sequence[torch.Tensor]) -> bool:
    """Whether the kernel reproduces ``opt``'s exact semantics over
    ``params``: ``type(opt) is Adam``, no grad clip, no weight decay, no
    multi-precision, every parameter f32 (paddle_tpu's rules)."""
    from ..optimizer.optimizer import Adam
    return (type(opt) is Adam and opt._grad_clip is None
            and opt._weight_decay is None and not opt._multi_precision
            and all(fused_adam_supported(p.shape, p.dtype) for p in params))


def fused_update_for(opt, params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     states: Sequence[dict]) -> Optional[FusedAdam]:
    """A :class:`FusedAdam` over ``params`` (with their grad buffers and
    ``{"m", "v"}`` slots) when, and only when,
    :func:`fused_adam_eligible`; else None."""
    if not fused_adam_eligible(opt, params):
        return None
    return FusedAdam(params, grads, [s["m"] for s in states],
                     [s["v"] for s in states], opt._beta1, opt._beta2,
                     opt._eps)
