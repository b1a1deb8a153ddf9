"""Gradient clipping by global norm (paddle_tpu.optimizer.clip)."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        """``[(param or None, grad)]`` -> the same with clipped grads."""
        raise NotImplementedError


def _sharded_axes(p):
    """The mesh axes (of size > 1) a tensor-parallel parameter is split
    over (its ``placement``), or ()."""
    spec = getattr(p, "placement", None)
    if not spec:
        return ()
    from ..distributed.mesh import axis_size
    return tuple(a for a in spec if a is not None and axis_size(a) > 1)


def _global_norm(params, grads):
    """2-norm of ``grads`` together; a gradient split over mesh axes
    adds its square sum over those axes (each rank holds one share)."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    axes = [_sharded_axes(p) for p in params]
    if not any(axes):
        return torch.linalg.vector_norm(torch.stack(norms))
    from ..distributed.collective import all_reduce
    sq = torch.stack(norms) ** 2
    total = sq[[not a for a in axes]].sum()
    for ax in sorted({a for a in axes if a}):
        part = sq[[a == ax for a in axes]].sum()
        for name in ax:
            all_reduce(part, group=name)
        total = total + part
    return torch.sqrt(total)


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every grad by ``clip / max(norm, clip)``, ``norm`` the
    2-norm of all of them together (params with ``need_clip = False``
    neither count nor scale).  The norm is summed in f32 whatever the
    grads' type, the clipped grads are f32, and the scale stays on the
    device: no host sync.  Under tensor parallelism the square sums of
    the gradients split over 'mp' are all-reduced over 'mp' (the norm of
    the whole gradient, the same on every rank)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        if not params_grads:
            return params_grads
        clip = [getattr(p, "need_clip", True) for p, _ in params_grads]
        grads = [g for (_, g), c in zip(params_grads, clip) if c]
        if not grads:
            return params_grads
        global_norm = _global_norm(
            [p for (p, _), c in zip(params_grads, clip) if c], grads)
        scale = self.clip_norm / torch.clamp(global_norm,
                                             min=self.clip_norm)
        # a bf16 grad comes back f32 for the f32 master update
        # (paddle_tpu rounds it back to bf16)
        return [(p, g.float() * scale if c else g)
                for (p, g), c in zip(params_grads, clip)]
