"""Tensor-parallel (Megatron-style) layers (the counterpart of
``paddle_tpu/parallel/tp_layers.py``).

In the JAX package a TP layer is an ordinary layer whose weight carries
a ``placement`` over the 'mp' mesh axis, and GSPMD inserts the
collectives.  PyTorch has no GSPMD, so here each rank holds only its
shard and the layers write the collectives out, through the fused
collective matmuls (:mod:`..ops.collective_matmul`, whose chunk products
are K6 on the card).  The outputs are what the JAX layers give: full,
and replicated over 'mp'.

- :class:`ColumnParallelLinear`: weight ``[in, out/mp]`` (placement
  ``(None, 'mp')``), bias ``[out/mp]``.  Forward: the replicated input
  enters through :func:`~..distributed.collective.copy_to_group` (its
  backward all-reduces dx over 'mp'), then ``all_gather_matmul`` and the
  gathered bias (``gather_output=False`` keeps this rank's columns).
- :class:`RowParallelLinear`: weight ``[in/mp, out]`` (placement
  ``('mp', None)``), bias ``[out]`` replicated.  Forward: this rank's
  slice of the input (backward: all-gather of dx), ``matmul_reduce_scatter``
  and an all-gather of the row blocks, one autograd Function whose
  backward takes the replicated dy as it is, then the bias.
- :class:`VocabParallelEmbedding`: rows ``[V/mp, H]``, the vocab padded
  to a multiple of 'mp' as GSPMD pads an uneven shard; ids outside this
  rank's rows look up zeros, and the sum over 'mp' is the lookup.
- :class:`ParallelCrossEntropy`: mean cross entropy over logits split
  along the vocab over 'mp' (what ``ColumnParallelLinear(...,
  gather_output=False)`` gives): max, sum of exponentials and target
  logit all-reduced over 'mp'; the backward is local.

The backward products (dx, dw) are ``torch.matmul``: the JAX package
computes them outside any Pallas kernel (``chunk_matmul`` has no VJP).
Initial weights are drawn whole, by ``weight_attr``'s initializer
(else XavierNormal, Normal(0, 0.02) for the embedding) from the seeded
generator, and cut, so every mp degree starts from the same full
weights; a shard keeps the attr's name, ``need_clip``, regularizer and
learning rate.
"""
from __future__ import annotations

import torch

from ..core.placement import device as _resolve_device
from ..core.tensor import Parameter
from ..distributed.collective import (_gather, _resolve, all_reduce,
                                      copy_to_group, gather_from_group,
                                      reduce_from_group, scatter_to_group)
from ..distributed.mesh import MP_AXIS
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer_base import Layer
from ..ops.collective_matmul import (_chunk_mm, all_gather_matmul,
                                     matmul_reduce_scatter)

__all__ = ["set_placement", "mark_placement", "get_placement",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "split"]


def set_placement(param, *spec):
    """Attach a placement (one entry per dim: a mesh axis or None)."""
    param.placement = tuple(spec)
    return param


mark_placement = set_placement


def get_placement(param):
    return getattr(param, "placement", None)


def _shard(full: torch.Tensor, dim: int, group, like=None) -> Parameter:
    """This rank's block of ``full``, a Parameter with the ParamAttr-given
    attributes of ``like`` (default: ``full``)."""
    g, like = _resolve(group), full if like is None else like
    trainable = (like.requires_grad
                 if isinstance(like, torch.nn.Parameter) else True)
    p = Parameter(full.detach().chunk(g.nranks, dim=dim)[g.rank].contiguous(),
                  requires_grad=trainable)
    for k in ("param_name", "need_clip", "regularizer", "optimize_attr"):
        if k in like.__dict__:
            setattr(p, k, like.__dict__[k])
    return p


def _mp_divides(n: int, what: str, g) -> None:
    if n % g.nranks:
        raise ValueError(f"{what} {n} is not divisible by the 'mp' size "
                         f"{g.nranks}")


class _AllGatherMatmul(torch.autograd.Function):
    """y = x @ all_gather(w) over ``group``; backward: dx = dy_mine @
    w^T (a partial sum, completed by copy_to_group's all-reduce) and dw =
    x^T @ dy_mine, dy_mine this rank's column block."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return all_gather_matmul(x, w, group, group.nranks)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        nc, r = w.shape[1], ctx.group.rank
        dy = dy[:, r * nc:(r + 1) * nc]
        return torch.matmul(dy, w.t()), torch.matmul(x.t(), dy), None


class _LocalMatmul(torch.autograd.Function):
    """y = x @ w through the chunk dispatch (K6 on the card)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _chunk_mm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return torch.matmul(dy, w.t()), torch.matmul(x.t(), dy)


class _RowParallelMatmul(torch.autograd.Function):
    """y = sum_r x_r @ w_r, full and replicated over ``group``: this
    rank's row block from ``matmul_reduce_scatter``, then an all-gather
    of the row blocks.  The consumers are replicated, so the backward
    takes the full dy as it is: dx = dy @ w^T, dw = x^T @ dy."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        rows = matmul_reduce_scatter(x, w, group, group.nranks)
        return rows if group.nranks == 1 else _gather(rows, group)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return torch.matmul(dy, w.t()), torch.matmul(x.t(), dy), None


def _flat(x):
    return x.reshape(-1, x.shape[-1])


class ColumnParallelLinear(Layer):
    """W split along the output dim over 'mp' (reference:
    collective.py:735 axis=1); output gathered unless
    ``gather_output=False``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, name=None, device=None):
        super().__init__()
        dev = _resolve_device(device)
        self.group = _resolve(MP_AXIS)
        _mp_divides(out_features, "out_features", self.group)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        full = self.create_parameter((in_features, out_features),
                                     weight_attr,
                                     default_initializer=I.XavierNormal(),
                                     device=dev)
        self.weight = set_placement(_shard(full, 1, self.group), None, MP_AXIS)
        self.bias = None
        if has_bias:
            self.bias = set_placement(_shard(torch.zeros(
                out_features, device=dev), 0, self.group), MP_AXIS)

    def forward(self, x):
        lead = x.shape[:-1]
        x = copy_to_group(_flat(x), self.group)
        if self.gather_output:
            y = _AllGatherMatmul.apply(x, self.weight, self.group)
            if self.bias is not None:
                y = y + gather_from_group(self.bias, self.group, dim=0)
        else:
            y = _LocalMatmul.apply(x, self.weight)
            if self.bias is not None:
                y = y + self.bias
        return y.reshape(*lead, y.shape[-1])


class RowParallelLinear(Layer):
    """W split along the input dim over 'mp' (reference: collective.py:735
    axis=0); the partial products are reduce-scattered, then gathered.
    ``input_is_parallel``: ``x`` already is this rank's slice."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, name=None,
                 device=None):
        super().__init__()
        dev = _resolve_device(device)
        self.group = _resolve(MP_AXIS)
        _mp_divides(in_features, "in_features", self.group)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        full = self.create_parameter((in_features, out_features),
                                     weight_attr,
                                     default_initializer=I.XavierNormal(),
                                     device=dev)
        self.weight = set_placement(_shard(full, 0, self.group), MP_AXIS, None)
        self.bias = (Parameter(torch.zeros(out_features, device=dev))
                     if has_bias else None)

    def forward(self, x):
        lead = x.shape[:-1]
        if not self.input_is_parallel:
            x = scatter_to_group(x, self.group, dim=-1)
        y = _RowParallelMatmul.apply(_flat(x), self.weight, self.group)
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*lead, y.shape[-1])


class VocabParallelEmbedding(Layer):
    """Embedding rows split over 'mp' (reference: collective.py:769).
    The table is ``ceil(V / mp) * mp`` rows (zero padding at the end);
    this rank holds rows ``[rank * per, (rank + 1) * per)``."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None, device=None):
        super().__init__()
        dev = _resolve_device(device)
        self.group = _resolve(MP_AXIS)
        n = self.group.nranks
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.per = -(-num_embeddings // n)
        table = self.create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=I.Normal(0.0, 0.02), device=dev)
        full = torch.zeros((self.per * n, embedding_dim), device=dev)
        full[:num_embeddings] = table.detach()
        self.weight = set_placement(_shard(full, 0, self.group, table),
                                    MP_AXIS, None)

    def forward(self, ids):
        lo = self.group.rank * self.per
        mine = (ids >= lo) & (ids < lo + self.per)
        local = torch.where(mine, ids - lo, torch.zeros_like(ids))
        out = F.embedding(local, self.weight)
        out = out * mine.unsqueeze(-1).to(out.dtype)
        return reduce_from_group(out, self.group)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        z = logits.float()
        lo = group.rank * z.shape[-1]
        m = z.max(dim=-1).values
        all_reduce(m, "max", group)
        e = torch.exp(z - m[:, None])
        s = e.sum(dim=-1)
        all_reduce(s, "sum", group)
        keep = label != ignore_index
        mine = keep & (label >= lo) & (label < lo + z.shape[-1])
        idx = torch.where(mine, label - lo, torch.zeros_like(label)).long()
        tgt = z.gather(1, idx[:, None])[:, 0] * mine
        all_reduce(tgt, "sum", group)
        count = keep.sum().clamp_min(1).float()
        loss = ((torch.log(s) + m - tgt) * keep).sum() / count
        ctx.save_for_backward(e, s, idx, mine, keep, count)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, idx, mine, keep, count = ctx.saved_tensors
        d = e / s[:, None]
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, idx] -= mine.to(d.dtype)
        d = d * (keep[:, None] * (g.float() / count))
        return d.to(ctx.dtype), None, None, None


class ParallelCrossEntropy(Layer):
    """Mean cross entropy over vocab-split logits ``[..., V/mp]`` (this
    rank's columns, in mp order) and labels ``[...]`` of the full vocab.
    With mp of one it is ``F.cross_entropy``."""

    def __init__(self, name=None, ignore_index=-100):
        super().__init__()
        self.group = _resolve(MP_AXIS)
        self.ignore_index = ignore_index

    def forward(self, logits, label):
        label = label.reshape(-1)
        return _VocabParallelCE.apply(_flat(logits), label, self.group,
                                      int(self.ignore_index))


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """``paddle.distributed.split`` parity (reference: collective.py:809):
    a new TP layer applied to ``x``, on ``x``'s device."""
    dev = x.device
    if operation == "linear":
        in_f, out_f = size
        if axis == 0:
            layer = RowParallelLinear(in_f, out_f, weight_attr,
                                      bias_attr is not False, device=dev)
        else:
            layer = ColumnParallelLinear(in_f, out_f, weight_attr,
                                         bias_attr is not False,
                                         gather_output=gather_out,
                                         device=dev)
        return layer(x)
    if operation == "embedding":
        n, d = size
        return VocabParallelEmbedding(n, d, weight_attr, device=dev)(x)
    raise ValueError(f"unsupported split operation: {operation}")
