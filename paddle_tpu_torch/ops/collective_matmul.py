"""Fused compute-collective matmuls for tensor parallelism (the
counterpart of ``paddle_tpu/ops/collective_matmul.py``).

- **column-parallel** (:func:`all_gather_matmul`): the weight is sharded
  on its output dim, ``y = x @ all_gather(w)``.  The ring form rotates
  the shards with single-chunk permutations and multiplies each as it
  arrives, writing it straight into its column block of the output.
  Every column block is the same K6 product whatever the ring size (K6
  sums each element over K in one fixed order), so the ring form is
  **bitwise** equal to gathering ``w`` and running K6 on the whole of it.
- **row-parallel** (:func:`matmul_reduce_scatter`): the weight is
  sharded on its input dim; each rank's partial product is
  reduce-scattered over rows.  The ring form sums the partials in
  ascending member order (``grad_comm._ascending_sum``), the same on
  every run.  ``ring=False`` takes the backend's reduce-scatter, whose
  order NCCL and gloo do not promise, so the two forms agree within a
  tolerance only (the JAX package has XLA's psum there, which it holds
  bitwise to the ascending sum).

:func:`_chunk_mm` keeps the JAX package's dispatch: K6
(:func:`~.chunk_matmul.chunk_matmul`; its plain version on the CPU)
where the gate takes the shape and the kernel tier
(``FLAGS_use_pallas_kernels``) is on, else the plain ``torch.matmul``.
``ring=False`` of the column form also goes through it (the JAX package
uses a plain matmul there), so on the card every chunk product the gate
takes is a K6 launch.

``axis_name`` is a mesh axis or a :class:`~..distributed.collective.Group`;
``axis_size`` must be its size.  These functions are not differentiable:
the tensor-parallel layers (:mod:`..parallel.tp_layers`) wrap them in
autograd Functions with the conjugate backward.
"""
from __future__ import annotations

import torch

from ..core.flags import get_flag
from ..distributed.collective import _resolve, collective_permute
from ..distributed.collective import reduce_scatter as _reduce_scatter
from ..distributed.grad_comm import (_ascending_sum, _chunked_all_to_all,
                                     gather_param)
from .chunk_matmul import chunk_matmul, chunk_matmul_supported

__all__ = ["all_gather_matmul", "matmul_reduce_scatter", "lowering_label"]


def _chunk_mm(x, w, out=None):
    """One chunk's matmul, into ``out`` when given: K6 where the gate
    takes the shape and the tier is on, else ``torch.matmul``."""
    if (get_flag("use_pallas_kernels") and x.dim() == 2
            and chunk_matmul_supported(tuple(x.shape), tuple(w.shape),
                                       x.dtype, w.dtype)):
        return chunk_matmul(x, w, out)
    y = torch.matmul(x, w)
    if out is None:
        return y
    out.copy_(y)
    return out


def lowering_label() -> str:
    """Which per-chunk matmul the dispatch selects right now."""
    return "kernel" if get_flag("use_pallas_kernels") else "composite"


def _group(axis_name, axis_size):
    g = _resolve(axis_name)
    if g.nranks != int(axis_size):
        raise ValueError(f"axis size {axis_size} given, the group "
                         f"{axis_name!r} has {g.nranks} ranks")
    return g


def all_gather_matmul(x, w, axis_name, axis_size: int, *, ring: bool = True):
    """Column-parallel: ``w`` is this rank's ``[K, N/size]`` shard; returns
    the full ``x @ W`` (``[M, N]``; ``x`` is ``[M, K]``)."""
    size = int(axis_size)
    if size <= 1:
        return _chunk_mm(x, w)
    g = _group(axis_name, size)
    if not ring:
        return _chunk_mm(x, gather_param(w, g, size, dim=w.dim() - 1))
    nc = w.shape[-1]
    out = torch.empty(x.shape[:-1] + (nc * size,),
                      dtype=torch.result_type(x, w), device=x.device)
    idx, cur = g.rank, w.contiguous()
    perm = [(d, (d - 1) % size) for d in range(size)]
    for step in range(size):
        # after `step` rotations this rank holds shard (idx + step) % size
        src = (idx + step) % size
        _chunk_mm(x, cur, out[..., src * nc:(src + 1) * nc])
        if step < size - 1:
            cur = collective_permute(cur, perm, g)
    return out


def matmul_reduce_scatter(x, w, axis_name, axis_size: int, *,
                          ring: bool = True):
    """Row-parallel: ``x`` is this rank's ``[M, K/size]`` slice of the
    activations, ``w`` its ``[K/size, N]`` shard; returns this rank's
    ``[M/size, N]`` row block of the full product."""
    size = int(axis_size)
    partial = _chunk_mm(x, w)
    if size <= 1:
        return partial
    g = _group(axis_name, size)
    m = partial.shape[0]
    if m % size:
        raise ValueError(
            f"matmul_reduce_scatter: leading dim {m} is not divisible "
            f"by axis size {size} — pad the batch or keep the matmul "
            f"column-parallel.")
    if ring:
        rows = partial.reshape((size, m // size) + tuple(partial.shape[1:]))
        return _ascending_sum(_chunked_all_to_all(rows, g), size)
    return _reduce_scatter(partial, group=g)
