"""ShardedEmbedding: an embedding table whose rows are cut over a mesh
axis (the counterpart of ``paddle_tpu/parallel/sharded_embedding.py``,
the parameter-server replacement for tables too large for one device).

Each rank holds ``vocab / n`` rows (its ``weight``, carrying
``global_shape`` and the placement ``(axis,)``).  A lookup gathers the
rows this rank owns (ids outside its block read row 0 and are masked to
zero) and a sum over the axis assembles the result:

- over 'dp', where every rank holds its own slice of the batch, the ids
  of the group are all-gathered, each rank looks up the rows it owns
  for all of them, and a reduce-scatter gives each rank the rows of its
  own ids; the backward all-gathers the cotangents, so the owner's
  rows take the gradient of every rank's loss (their sum: the data-
  parallel step divides it by the dp size instead of averaging it over
  ranks, which hold different rows);
- over an axis the batch is not cut over (the ranks hold the same ids),
  an all-reduce, whose backward keeps each rank's cotangent.

Either way the gradient is a scatter-add into the owner's touched rows
only: the rows no id reached keep a zero gradient, as SelectedRows
would.  Where no mesh axis applies (no mesh, a missing axis or one of
size one) the lookup is ``F.embedding`` with ``sparse=True``'s
SelectedRows gradient.  ``offload='pinned_host'`` warns and keeps the
table in device memory, as the JAX package does on a backend without
memory kinds.
"""
from __future__ import annotations

import warnings

import torch

from ..core.tensor import wrap
from ..distributed.collective import _gather, _resolve, axis_group
from ..distributed.mesh import DP_AXIS, get_mesh
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer_base import Layer
from .tp_layers import _shard, set_placement

__all__ = ["ShardedEmbedding"]


class _RowShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_rows, ids, group, gathered):
        import torch.distributed as dist
        n, r = group.nranks, group.rank
        rows_per = w_rows.shape[0]
        ids_all = _gather(ids, group, 0) if gathered else ids
        local = ids_all - r * rows_per
        ok = (local >= 0) & (local < rows_per)
        safe = local.clamp(0, rows_per - 1)
        out = w_rows[safe] * ok.unsqueeze(-1).to(w_rows.dtype)
        if gathered:
            from ..distributed.collective import reduce_scatter
            out = reduce_scatter(out.contiguous(), group=group)
        else:
            dist.all_reduce(out, group=group.process_group)
        ctx.save_for_backward(safe, ok)
        ctx.group, ctx.gathered, ctx.n = group, gathered, n
        ctx.w_shape = w_rows.shape
        return out

    @staticmethod
    def backward(ctx, g):
        safe, ok = ctx.saved_tensors
        g_all = _gather(g.contiguous(), ctx.group, 0) if ctx.gathered else g
        dw = g_all.new_zeros(ctx.w_shape)
        dw.index_add_(0, safe[ok], g_all[ok])
        return dw, None, None, None


class ShardedEmbedding(Layer):
    """Embedding whose rows are cut over a mesh axis.

    Args:
        num_embeddings / embedding_dim: table shape.
        axis: mesh axis to cut the rows over (default 'dp': capacity
            sharding, every data rank owns vocab/n rows).
        offload: None or 'pinned_host' (warns: the table stays in device
            memory).
        sparse: SelectedRows gradients where no mesh axis applies."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 axis: str = "dp", offload=None, sparse: bool = True,
                 weight_attr=None, name=None, device=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._axis = axis
        self._sparse = sparse
        mesh = get_mesh()
        n = mesh.axis_size(axis) if mesh is not None else 1
        if (mesh is not None and axis in mesh.shape
                and num_embeddings % n != 0):
            raise ValueError(
                f"num_embeddings ({num_embeddings}) must be divisible by "
                f"mesh axis '{axis}' size ({n}) — otherwise "
                f"the table would silently replicate onto every chip; pad "
                f"the vocab to a multiple")
        weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 0.02), device=device)
        self._group = None
        if n > 1:
            self._group = axis_group(axis, mesh)
            weight = _shard(weight, 0, self._group)
            weight.global_shape = (num_embeddings, embedding_dim)
        self.weight = weight
        set_placement(self.weight, axis)
        if offload:
            warnings.warn(f"host offload unavailable on this backend "
                          f"({offload!r}: no memory kinds); table stays "
                          f"in device memory")

    def forward(self, ids):
        if self._group is None:
            return F.embedding(ids, self.weight, sparse=self._sparse)
        g = _resolve(self._group)
        return wrap(_RowShardedLookup.apply(self.weight, ids, g,
                                            self._axis == DP_AXIS))

    def extra_repr(self):
        return (f"{self._num_embeddings}, {self._embedding_dim}, "
                f"axis={self._axis!r}")
