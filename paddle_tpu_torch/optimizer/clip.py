"""Gradient clipping (paddle_tpu.optimizer.clip): by value, by each
gradient's norm, and by the global norm, plus the torch-style
:func:`clip_grad_norm_`.

A sparse gradient (:class:`~..core.selected_rows.SelectedRows`) takes
part as paddle_tpu's does (the reference's ``merge_selected_rows``
path): its duplicate rows are merged first, its values enter the norms
(unmerged duplicates would give another norm), and the scaling keeps it
sparse."""
from __future__ import annotations

import torch

from ..core.selected_rows import SelectedRows
from ..core.tensor import raw_grad, wrap

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def _merged(g):
    return g.merge() if isinstance(g, SelectedRows) else g


def _dense_part(g):
    """The tensor whose entries count in a norm: a SelectedRows' values."""
    return g.values if isinstance(g, SelectedRows) else g


def _scaled(g, scale):
    if isinstance(g, SelectedRows):
        return SelectedRows(g.rows, g.values.float() * scale, g.height,
                            g.merged)
    return g.float() * scale


class ClipGradBase:
    def __call__(self, params_grads):
        """``[(param or None, grad)]`` -> the same with clipped grads."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Every gradient entry clamped to ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            g = _merged(g)
            if isinstance(g, SelectedRows):
                g = SelectedRows(g.rows, torch.clamp(g.values, self.min,
                                                     self.max), g.height,
                                 g.merged)
            else:
                g = torch.clamp(g, self.min, self.max)
            out.append((p, g))
        return out


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip / norm, 1)``, ``norm`` its own
    2-norm (in f32; the scale stays on the device)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            g = _merged(g)
            norm = torch.linalg.vector_norm(_dense_part(g),
                                            dtype=torch.float32)
            scale = torch.clamp(self.clip_norm / torch.clamp(norm,
                                                             min=1e-12),
                                max=1.0)
            out.append((p, _scaled(g, scale)))
        return out


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
    norms = torch._foreach_norm([_dense_part(g) for g in grads], 2,
                                dtype=torch.float32)
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
        params_grads = [(p, _merged(g)) for p, g in params_grads]
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
        return [(p, _scaled(g, scale) if c else g)
                for (p, g), c in zip(params_grads, clip)]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients in place by ``min(max_norm /
    total, 1)``, ``total`` the ``norm_type``-norm of all of them
    together (``inf``: the largest magnitude); returns ``total``.  A
    sparse gradient counts with its duplicate rows summed."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    params = [p for p in parameters if raw_grad(p) is not None]
    if not params:
        return wrap(torch.zeros(()))
    grads = [raw_grad(p) for p in params]
    entries = [g.coalesce().values() if g.is_sparse else g for g in grads]
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([e.abs().max() for e in entries]).max()
    else:
        total = torch.stack([(e.abs() ** norm_type).sum()
                             for e in entries]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    with torch.no_grad():
        for g in grads:
            (g._values() if g.is_sparse else g).mul_(scale.to(g.dtype))
    return wrap(total)
