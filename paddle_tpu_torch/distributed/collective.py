"""Collective communication over ``torch.distributed`` (the counterpart
of ``paddle_tpu/distributed/collective.py``).

In the JAX package a collective is a ``jax.lax`` op over a named mesh
axis inside ``shard_map``.  Here every process is one device, so the
same calls are real collectives between processes: NCCL between cards,
gloo between CPU processes.  ``spmd`` is therefore the identity.

A ``group`` is a :class:`Group`, a mesh axis name (this rank's line of
that axis, see :mod:`.mesh`), or None for the whole world.  Ranks given
to ``broadcast``, ``send``, ``recv`` and ``collective_permute`` are
indices inside the group (the JAX package's axis indices).  Over a group
of one rank every collective is the identity and nothing is sent.

Two kinds of function:

- the paddle API (``all_reduce`` ... ``barrier``), not differentiable;
  ``all_reduce`` and ``broadcast`` work in place and return the tensor,
  the others return new tensors (a result of another shape cannot be
  written into the argument, as the JAX package rebinds it);
- the differentiable forms the parallel layers are built from, each a
  ``torch.autograd.Function`` whose backward is the conjugate
  collective: :func:`ppermute` (backward: the reverse permutation),
  :func:`copy_to_group` (identity; backward all-reduce),
  :func:`reduce_from_group` (all-reduce; backward identity),
  :func:`scatter_to_group` (this rank's slice; backward all-gather) and
  :func:`gather_from_group` (all-gather; backward this rank's slice).
  They are right when what the group computes downstream is replicated
  over it: every rank then holds the same cotangent.  :func:`psum` is
  ``jax.lax.psum`` as ``shard_map`` differentiates it: all-reduce both
  ways, so a cotangent that only some ranks hold (the rank that uses a
  broadcast value) reaches every rank, and a mask before the psum sends
  it to the rank that owns the value.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import get_mesh

__all__ = ["ReduceOp", "Group", "axis_group", "new_group", "get_group",
           "barrier", "all_reduce", "all_gather", "all_gather_object",
           "in_spmd", "broadcast", "reduce",
           "reduce_scatter", "scatter", "alltoall", "send", "recv", "shift",
           "collective_permute", "spmd", "ppermute", "copy_to_group",
           "reduce_from_group", "scatter_to_group", "gather_from_group",
           "psum"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A set of ranks that communicate: a mesh axis (this rank's line of
    it), an explicit rank list, or the world.

    ``ranks`` are global ranks in group order, ``rank`` this process's
    index in it (-1 outside), ``process_group`` the torch group (None for
    the world or a group of one)."""

    def __init__(self, axis_name: Optional[str] = None, ranks=None, id=0,
                 process_group=None):
        self.axis_name = axis_name
        self._ranks = None if ranks is None else [int(r) for r in ranks]
        self.id = id
        self._pg = process_group

    def _bind(self):
        if self.axis_name is not None and self._ranks is None:
            mesh = get_mesh()
            if mesh is None or self.axis_name not in mesh.shape:
                return [dist.get_rank() if dist.is_initialized() else 0], None
            return mesh.line(self.axis_name), mesh.group(self.axis_name)
        if self._ranks is None:
            n = dist.get_world_size() if dist.is_initialized() else 1
            return list(range(n)), None
        return self._ranks, self._pg

    @property
    def ranks(self) -> List[int]:
        return self._bind()[0]

    @property
    def process_group(self):
        return self._bind()[1]

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        me = dist.get_rank() if dist.is_initialized() else 0
        ranks = self.ranks
        return ranks.index(me) if me in ranks else -1

    def __repr__(self):
        return (f"Group(axis={self.axis_name!r}, ranks={self.ranks}, "
                f"id={self.id})")


_world = Group()


def _resolve(group) -> Group:
    if group is None:
        return _world
    if isinstance(group, Group):
        return group
    if isinstance(group, str):
        return Group(group)
    raise TypeError(f"group must be a Group, a mesh axis name or None, "
                    f"not {type(group).__name__}")


def axis_group(axis_name: str, mesh=None) -> Group:
    """This rank's line of ``axis_name`` in ``mesh`` (default: the
    installed one), as a bound Group."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return Group(axis_name)
    return Group(axis_name, mesh.line(axis_name),
                 process_group=mesh.group(axis_name))


def new_group(ranks=None, backend=None, axis_name: Optional[str] = None):
    """reference: collective.py:163.  With ``ranks``, a new torch group
    over those global ranks: like ``torch.distributed.new_group`` every
    rank must call it, in the same order.  With ``axis_name``, the mesh
    axis (no new group is made)."""
    if ranks is None:
        return Group(axis_name)
    ranks = [int(r) for r in ranks]
    pg = dist.new_group(ranks, backend=backend) if len(ranks) > 1 else None
    return Group(axis_name, ranks, process_group=pg)


def get_group(id=0):
    return _world


def in_spmd():
    """The axis names of the innermost ``spmd`` region, or None.  Each
    process here is one device and ``spmd`` is the identity, so no code
    runs inside such a region: always None."""
    return None


def all_gather_object(obj_list, obj, group=None):
    """Every rank's picklable ``obj``, in group order, appended to
    ``obj_list`` (which is returned)."""
    g = _resolve(group)
    if g.nranks == 1:
        obj_list.append(obj)
        return obj_list
    got = [None] * g.nranks
    dist.all_gather_object(got, obj, group=g.process_group)
    obj_list.extend(got)
    return obj_list


def spmd(fn=None, **_kw):
    """The JAX package's per-device region.  Each process already is
    one device, so this is the identity (decorator or call)."""
    if fn is None:
        return lambda f: f
    return fn


def barrier(group=None):
    g = _resolve(group)
    if g.nranks > 1:
        dist.barrier(group=g.process_group)


# ----------------------------------------------------------- collectives
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place over ``group``; AVG is a sum then a division (gloo has no
    average)."""
    g = _resolve(group)
    if g.nranks == 1:
        return tensor
    if op == ReduceOp.AVG:
        dist.all_reduce(tensor, dist.ReduceOp.SUM, group=g.process_group)
        tensor.div_(g.nranks)
        return tensor
    if op not in _TORCH_OPS:
        raise ValueError(f"all_reduce: unknown op {op!r}")
    dist.all_reduce(tensor, _TORCH_OPS[op], group=g.process_group)
    return tensor


def _gather(tensor, g: Group, axis: int = 0):
    parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
    dist.all_gather(parts, tensor.contiguous(), group=g.process_group)
    return torch.cat(parts, dim=axis)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor`` concatenated along ``axis`` in group order
    (JAX's tiled ``all_gather``); ``tensor_list``, when given, is
    extended with the pieces."""
    g = _resolve(group)
    out = tensor if g.nranks == 1 else _gather(tensor, g, axis)
    if tensor_list is not None:
        tensor_list.extend(out.chunk(g.nranks, dim=axis))
    return out


def broadcast(tensor, src=0, group=None, sync_op=True):
    """In place: the value of group member ``src`` wins."""
    g = _resolve(group)
    if g.nranks > 1:
        dist.broadcast(tensor, g.ranks[src], group=g.process_group)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """As in the JAX package: the reduction lands on every rank (a
    superset of what ``dst`` needs)."""
    return all_reduce(tensor, op, group)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """This rank's block (dim 0, in group order) of the sum over the
    group (JAX's tiled ``psum_scatter``); returns it."""
    g = _resolve(group)
    if g.nranks == 1:
        return tensor
    if tensor.shape[0] % g.nranks:
        raise ValueError(f"reduce_scatter: leading dim {tensor.shape[0]} "
                         f"is not divisible by the group size {g.nranks}")
    if op != ReduceOp.SUM:
        raise NotImplementedError(f"reduce_scatter: op {op!r} (SUM only)")
    if tensor.is_cuda:
        out = tensor.new_empty((tensor.shape[0] // g.nranks,)
                               + tuple(tensor.shape[1:]))
        dist.reduce_scatter_tensor(out, tensor.contiguous(),
                                   group=g.process_group)
        return out
    full = tensor.clone()                  # gloo: no reduce_scatter
    dist.all_reduce(full, group=g.process_group)
    return full.chunk(g.nranks, dim=0)[g.rank].contiguous()


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Group member ``src``'s ``tensor`` cut along dim 0; returns this
    rank's piece."""
    g = _resolve(group)
    if tensor.shape[0] % g.nranks:
        raise ValueError(f"scatter: leading dim {tensor.shape[0]} is not "
                         f"divisible by the group size {g.nranks}")
    if g.nranks == 1:
        return tensor
    full = broadcast(tensor.clone(), src, g)
    return full.chunk(g.nranks, dim=0)[g.rank].contiguous()


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """Piece k of this rank goes to member k; returns the pieces received,
    concatenated in source order (also appended to ``out_tensor_list``).
    Built from single-piece permutations (``grad_comm._chunked_all_to_all``),
    which gloo and NCCL both carry."""
    from .grad_comm import _chunked_all_to_all
    g = _resolve(group)
    rows = (torch.stack(list(in_tensor_list))
            if isinstance(in_tensor_list, (list, tuple))
            else in_tensor_list.reshape((g.nranks, -1)
                                        + tuple(in_tensor_list.shape[1:])))
    got = _chunked_all_to_all(rows, g)
    if out_tensor_list is not None:
        out_tensor_list.extend(got.unbind(0))
    return got.reshape((-1,) + tuple(got.shape[2:]))


def send(tensor, dst=0, group=None, sync_op=True):
    g = _resolve(group)
    dist.send(tensor.contiguous(), g.ranks[dst], group=g.process_group)


def recv(tensor, src=0, group=None, sync_op=True):
    g = _resolve(group)
    dist.recv(tensor, g.ranks[src], group=g.process_group)
    return tensor


def collective_permute(tensor, perm: Sequence[Tuple[int, int]], group=None):
    """JAX's ``ppermute``: for each pair ``(i, j)`` member i's tensor
    goes to member j; a member that receives nothing gets zeros.  All
    sends and receives of one call are posted together
    (``batch_isend_irecv``)."""
    g = _resolve(group)
    n, me = g.nranks, g.rank
    if n == 1:
        return tensor.clone() if any(i == j == 0 for i, j in perm) \
            else torch.zeros_like(tensor)
    tensor = tensor.contiguous()
    out = torch.zeros_like(tensor)
    ops = []
    for i, j in perm:
        if i == me and j == me:
            out.copy_(tensor)
        elif i == me:
            ops.append(dist.P2POp(dist.isend, tensor, g.ranks[j],
                                  group=g.process_group))
        elif j == me:
            ops.append(dist.P2POp(dist.irecv, out, g.ranks[i],
                                  group=g.process_group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def shift(tensor, offset: int = 1, group=None):
    """Every member receives the tensor of the member ``offset`` places
    before it."""
    n = _resolve(group).nranks
    return collective_permute(tensor, [(i, (i + offset) % n)
                                       for i in range(n)], group)


# ------------------------------------------------ differentiable forms
class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return collective_permute(x, perm, group)

    @staticmethod
    def backward(ctx, dy):
        back = [(j, i) for i, j in ctx.perm]
        return collective_permute(dy, back, ctx.group), None, None


def ppermute(x, perm, group=None):
    """Differentiable :func:`collective_permute`: the cotangent travels
    back along the reverse permutation."""
    perm = tuple((int(i), int(j)) for i, j in perm)
    return _PPermute.apply(x, perm, _resolve(group))


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous().clone(), group=ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous().clone(), group=ctx.group), None


def _my_slice(x, g: Group, dim: int):
    return x.chunk(g.nranks, dim=dim)[g.rank]


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _my_slice(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, ctx.group, ctx.dim), None, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _my_slice(dy, ctx.group, ctx.dim), None, None


def _dim(x, dim):
    return dim % x.dim()


def copy_to_group(x, group):
    """Identity forward; the backward all-reduces (sums) the cotangent:
    a replicated input that feeds a sharded computation."""
    g = _resolve(group)
    return x if g.nranks == 1 else _CopyToGroup.apply(x, g)


def reduce_from_group(x, group):
    """All-reduce (sum) forward; identity backward: partial results made
    replicated."""
    g = _resolve(group)
    return x if g.nranks == 1 else _ReduceFromGroup.apply(x, g)


def scatter_to_group(x, group, dim: int = -1):
    """This rank's slice of a replicated ``x`` along ``dim`` (a view);
    the backward all-gathers the slices' cotangents."""
    g = _resolve(group)
    if g.nranks == 1:
        return x
    if x.shape[dim] % g.nranks:
        raise ValueError(f"scatter_to_group: dim {dim} of size "
                         f"{x.shape[dim]} is not divisible by the group "
                         f"size {g.nranks}")
    return _ScatterToGroup.apply(x, g, _dim(x, dim))


def gather_from_group(x, group, dim: int = -1):
    """Every rank's ``x`` concatenated along ``dim``; the backward keeps
    this rank's slice (the consumers are replicated, so no sum)."""
    g = _resolve(group)
    return x if g.nranks == 1 else _GatherFromGroup.apply(x, g, _dim(x, dim))


def psum(x, group):
    """All-reduce (sum) forward and backward: the transpose of a sum over
    the group is the sum of the cotangents.  Where only the ranks that
    consume the result hold a cotangent, each rank gets their sum (a mask
    applied before the psum then keeps it on the rank whose value was
    broadcast)."""
    g = _resolve(group)
    return x if g.nranks == 1 else _PSum.apply(x, g)
