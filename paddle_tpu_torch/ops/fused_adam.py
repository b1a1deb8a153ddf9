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
                          beta1=0.9, beta2=0.999, eps=1e-8) -> None:
    """Plain version of the kernel, in place over lists of f32 tensors;
    ``lr`` and ``step`` are f32 scalar tensors."""
    bc1 = 1.0 - torch.exp(step * math.log(beta1))
    bc2 = 1.0 - torch.exp(step * math.log(beta2))
    for p, g, m, v in zip(params, grads, ms, vs):
        m.copy_(beta1 * m + (1.0 - beta1) * g)
        v.copy_(beta2 * v + (1.0 - beta2) * g * g)
        p.copy_(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))


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
    def __call__(self, lr: torch.Tensor, step: torch.Tensor) -> None:
        if self.table is not None:
            _cuda.fused_adam(self.table, lr, step, **self.kw)
        else:
            fused_adam_reference_(*self.lists, lr, step, **self.kw)


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
