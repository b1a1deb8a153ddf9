"""Ring attention: sequence (context) parallelism over the 'sp' mesh axis
(the counterpart of ``paddle_tpu/parallel/ring_attention.py``).

Each 'sp' rank keeps its query block and the key/value blocks travel
round the ring, one hop a round (:func:`~..distributed.collective.ppermute`,
whose backward sends the cotangents back the other way, so dK and dV
travel back round the ring).  Partial results merge by log-sum-exp
(:func:`merge_blocks`), so the result is exact attention over the whole
sequence.

The per-round math is the flash block (:func:`~..ops.flash_attention.
flash_attention_block`, the CUDA kernels on the card) when the local
shard's shape is one the kernels take, else the plain running-softmax
body.  Causality rides the global offsets ``q_off = my * L`` and ``k_off
= src * L``: rounds holding earlier shards are fully visible, later
shards fully masked, the diagonal causal.  Without causality the port
passes ``causal=False`` (the JAX package puts K at offset -1e9).

Layout: ``[B, L, H, D]`` throughout (the JAX flash body swaps to ``[B,
H, L, D]`` for its kernel; the port's kernels read ``[B, L, H, D]``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.flags import get_flag
from ..distributed.collective import (_resolve, axis_group,
                                      gather_from_group, ppermute,
                                      scatter_to_group)
from ..distributed.mesh import SP_AXIS, ensure_mesh
from ..ops.flash_attention import (NEG_INF, flash_attention_block,
                                   flash_attention_supported, mha_reference)

__all__ = ["ring_attention", "ring_attention_per_device",
           "ring_attention_per_device_flash", "merge_blocks",
           "reference_attention"]


def _bhl_to_blh(t):
    """[B, H, L] stats -> [B, L, H, 1], to scale a [B, L, H, D] tensor."""
    return t.transpose(1, 2).unsqueeze(-1)


def merge_blocks(o, lse, o_b, lse_b):
    """One round's log-sum-exp merge (JAX: ``ring_attention.py:137-141``).

    ``(o, lse)`` is the running result (``o`` f32 ``[B, L, H, D]``, ``lse``
    f32 ``[B, H, L]``), ``(o_b, lse_b)`` one block's normalised output and
    lse.  A row that has seen no key (lse at or below -1e30 / 2) takes
    weight 0 and keeps lse -1e30, in the forward and in the backward:
    ``exp(-1e30 - (-1e30))`` is never used as a weight."""
    seen, seen_b = lse > 0.5 * NEG_INF, lse_b > 0.5 * NEG_INF
    new = torch.logaddexp(lse, lse_b)
    zero = torch.zeros((), dtype=new.dtype, device=new.device)
    w = torch.where(seen, torch.exp(lse - new), zero)
    w_b = torch.where(seen_b, torch.exp(lse_b - new), zero)
    new = torch.where(seen | seen_b, new, torch.full_like(new, NEG_INF))
    return o * _bhl_to_blh(w) + o_b.float() * _bhl_to_blh(w_b), new


def _ring(S):
    return [(i, (i + 1) % S) for i in range(S)]


def ring_attention_per_device_flash(q, k, v, axis_name=SP_AXIS,
                                    is_causal: bool = True,
                                    scale: Optional[float] = None):
    """The ring with the flash block per round: q/k/v are this rank's
    shards ``[B, L, H, D]``; returns this rank's output block."""
    g = _resolve(axis_name)
    S, my, Lq = g.nranks, g.rank, q.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    o = lse = None
    k_blk, v_blk = k, v
    for r in range(S):
        src = (my - r) % S
        o_b, lse_b = flash_attention_block(q, k_blk, v_blk, my * Lq,
                                           src * Lq, scale, is_causal)
        if S == 1:
            return o_b
        if o is None:
            o, lse = o_b.float(), lse_b
        else:
            o, lse = merge_blocks(o, lse, o_b, lse_b)
        if r < S - 1:
            k_blk = ppermute(k_blk, _ring(S), g)
            v_blk = ppermute(v_blk, _ring(S), g)
    return o.to(q.dtype)


def ring_attention_per_device(q, k, v, axis_name=SP_AXIS,
                              is_causal: bool = True,
                              scale: Optional[float] = None):
    """The ring with plain per-round math (running max, sum and
    unnormalised output in f32), differentiable by autograd."""
    g = _resolve(axis_name)
    S, my, Lq = g.nranks, g.rank, q.shape[1]
    B, _, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q_pos = my * Lq + torch.arange(Lq, device=q.device)
    o = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for r in range(S):
        src = (my - r) % S
        s = torch.einsum("blhd,bshd->bhls", q.float(), k_blk.float()) * scale
        if is_causal:
            k_pos = src * Lq + torch.arange(k_blk.shape[1], device=q.device)
            s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
        m_b = s.amax(dim=-1)
        new_m = torch.maximum(m, m_b)
        p = torch.exp(s - new_m[..., None]) * (s > 0.5 * NEG_INF)
        alpha = torch.exp(m - new_m)
        o = o * _bhl_to_blh(alpha) + torch.einsum("bhls,bshd->blhd", p,
                                                  v_blk.float())
        l = l * alpha + p.sum(dim=-1)
        m = new_m
        if r < S - 1:
            k_blk = ppermute(k_blk, _ring(S), g)
            v_blk = ppermute(v_blk, _ring(S), g)
    return (o / _bhl_to_blh(l.clamp_min(1e-20))).to(q.dtype)


def _flash_eligible(q) -> bool:
    if not get_flag("use_pallas_kernels"):
        return False
    shape = tuple(q.shape)
    return flash_attention_supported(shape, shape, q.dtype)


def ring_attention(q, k, v, is_causal=True, mesh=None,
                   axis_name: str = SP_AXIS):
    """q/k/v ``[B, L, H, D]``, full length and replicated over 'sp' ->
    the full-length output, replicated.  Inside, each 'sp' rank takes its
    shard of L (backward: all-gather), runs the ring, and all-gathers the
    output blocks (backward: its own block).  Exact attention over the
    whole sequence."""
    mesh = mesh or ensure_mesh()
    n = mesh.axis_size(axis_name)
    g = axis_group(axis_name, mesh)
    if q.shape[1] % n:
        raise ValueError(f"ring_attention: sequence length {q.shape[1]} is "
                         f"not divisible by the {axis_name!r} size {n}")
    ql, kl, vl = (scatter_to_group(t, g, dim=1) for t in (q, k, v))
    body = (ring_attention_per_device_flash if _flash_eligible(ql)
            else ring_attention_per_device)
    return gather_from_group(body(ql, kl, vl, g, is_causal), g, dim=1)


def reference_attention(q, k, v, is_causal=True):
    """Single-device oracle for tests (f32 inside)."""
    return mha_reference(q, k, v, causal=is_causal)
