"""The ring helpers of ``paddle_tpu/distributed/grad_comm.py`` that the
fused collective matmuls use: :func:`_chunked_all_to_all` (:969),
:func:`_ascending_sum` (:1001) and :func:`gather_param` (:1038).  The
gradient-communication stage itself (buckets, quantised wires, error
feedback) is not ported yet.

``group`` is what :mod:`.collective` takes (a Group, a mesh axis name or
None); the JAX package's ``(axis_name, size)`` pair becomes the group
and its size.
"""
from __future__ import annotations

import torch

from .collective import _gather, _resolve, collective_permute

__all__ = ["_chunked_all_to_all", "_ascending_sum", "gather_param"]


def _chunked_all_to_all(rows, group):
    """``all_to_all`` as ``n - 1`` single-chunk permutations: ``rows[k]``
    is the chunk for member k; returns ``[n, ...]`` whose row k is the
    chunk member k sent here.  At step s member d sends
    ``rows[(d - s) % n]`` to member ``(d - s) % n``."""
    g = _resolve(group)
    n, idx = g.nranks, g.rank
    got = [rows[idx]]
    for s in range(1, n):
        perm = [(d, (d - s) % n) for d in range(n)]
        got.append(collective_permute(rows[(idx - s) % n], perm, g))
    # got[s] came from member (idx + s) % n: roll so row k = member k
    return torch.roll(torch.stack(got), idx, dims=0)


def _ascending_sum(rows, n: int):
    """Left-to-right sum of ``rows[0..n-1]``: the accumulation order is
    the members' ascending order, the same on every run and every
    backend (NCCL and gloo reductions promise no order)."""
    total = rows[0]
    for k in range(1, n):
        total = total + rows[k]
    return total


def gather_param(shard, group, size: int, dim: int = 0):
    """All-gather one sharded tensor to its full value along ``dim`` (one
    collective; the JAX package's ``ring=True`` form, which the collective
    matmuls do not use, is not ported)."""
    if size <= 1:
        return shard
    g = _resolve(group)
    if g.nranks != size:
        raise ValueError(f"gather_param: size {size}, the group has "
                         f"{g.nranks} ranks")
    return _gather(shard, g, dim % shard.dim())
