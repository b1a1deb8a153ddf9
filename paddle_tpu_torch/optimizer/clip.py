"""Gradient clipping by global norm (paddle_tpu.optimizer.clip)."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        """``[(param or None, grad)]`` -> the same with clipped grads."""
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every grad by ``clip / max(norm, clip)``, ``norm`` the
    2-norm of all of them together (params with ``need_clip = False``
    neither count nor scale).  The norm is summed in f32 whatever the
    grads' type, the clipped grads are f32, and the scale stays on the
    device: no host sync."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        if not params_grads:
            return params_grads
        clip = [getattr(p, "need_clip", True) for p, _ in params_grads]
        grads = [g for (_, g), c in zip(params_grads, clip) if c]
        if not grads:
            return params_grads
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        global_norm = torch.linalg.vector_norm(torch.stack(norms))
        scale = self.clip_norm / torch.clamp(global_norm,
                                             min=self.clip_norm)
        # a bf16 grad comes back f32 for the f32 master update
        # (paddle_tpu rounds it back to bf16)
        return [(p, g.float() * scale if c else g)
                for (p, g), c in zip(params_grads, clip)]
