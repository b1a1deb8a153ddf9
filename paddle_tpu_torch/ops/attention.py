"""Paged attention: decode-phase attention over a page-table-indexed
KV cache.

The serving KV cache (:mod:`paddle_tpu_torch.serving.kv_cache`) stores
every sequence's keys/values in fixed-size *pages* of one preallocated
pool; a per-sequence page table (int32 page indices) maps logical token
positions to physical pages.

Two versions of one function, chosen by where the tensors lie:

- :func:`paged_attention_reference`, the plain PyTorch version: gather
  the K/V pages by page table, flatten to the per-sequence logical view,
  mask positions ``>= length``, dense softmax attention.  The CPU path
  and the oracle the CUDA kernel is held to.
- :func:`paddle_tpu_torch.ops.cuda.paged_attention_decode`, the
  hand-written CUDA kernel, which raises on shapes it does not take.

:func:`paged_attention_select` is the serving decode step's dispatch, as
in the JAX package: the kernel where :func:`kernel_supported` takes the
call (``FLAGS_use_pallas_kernels`` on, CUDA tensors, a dtype and shapes
the kernel was built for), the plain version for everything else, on
the card too.  The TPU's own gates (head dim % 128, page % 8) are its
tiling; the card's gate is the kernel's instance set.

:func:`register_paged_attention_kernel` installs a function with the
plain version's contract, as in the JAX package, where it is the only
way to a kernel.  Here it never takes a call the CUDA kernel takes: it
only adds a route where the JAX package would call it, among the calls
the kernel refuses (its gate less the TPU backend test: the flag on,
f32 or bf16, a head dim that is a multiple of 128, pages a multiple of
8, and the function's own ``supported`` if it has one).  ``None``
clears it.  :func:`paged_attention` is the public entry, in the JAX
signature, over :func:`paged_attention_select`.
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, Optional

import torch

from ..core.dispatch import apply
from ..core.flags import get_flag
from .cuda.paged_attention import (SUPPORTED_GROUPS, SUPPORTED_HEAD_DIMS,
                                   paged_attention_decode)

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_attention_select", "paged_attention_supported",
           "kernel_supported", "register_paged_attention_kernel"]

_NEG = -1e30

# the registered function (None: none registered)
_REGISTERED: Optional[Callable] = None


def register_paged_attention_kernel(fn: Optional[Callable]) -> None:
    """Install ``fn(q, k_pool, v_pool, page_table, lengths, scale[,
    layer])``, or clear it with ``None``; see the module docstring for
    the calls it takes."""
    global _REGISTERED
    _REGISTERED = fn


def registered_kernel() -> Optional[Callable]:
    return _REGISTERED


def paged_attention_reference(q, k_pool, v_pool, page_table, lengths,
                              scale=None, layer=None):
    """Gather-by-page-table attention (plain PyTorch).

    q: [S, H, D] one query token per sequence slot;
    k_pool/v_pool: [N, page, Hkv, D] the shared physical page pool —
    or the full [L, N, page, Hkv, D] stack with ``layer`` set;
    page_table: [S, P] int32 physical page per logical page;
    lengths: [S] int32 valid KV length (the current token included).
    Returns [S, H, D] in q's dtype, computed in f32.  H must be a
    multiple of Hkv (grouped-query attention broadcasts each KV head
    over H/Hkv query heads).  At ``lengths[s] == 0`` every position is
    masked and the softmax is uniform, so the row is the mean of V over
    the table's positions (the JAX reference's behaviour; the CUDA
    kernel returns zeros there)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    S, H, D = q.shape
    page = k_pool.shape[-3]
    Hkv = k_pool.shape[-2]
    P = page_table.shape[1]
    T = P * page                                   # logical KV capacity
    pt = page_table.long()
    if layer is not None:
        k_pool, v_pool = k_pool[layer], v_pool[layer]
    k = k_pool[pt].reshape(S, T, Hkv, D)
    v = v_pool[pt].reshape(S, T, Hkv, D)
    if Hkv != H:                                   # grouped-query attn
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("shd,sthd->sht", q.float(), k.float()) * float(scale)
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])      # [S, T]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, _NEG))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("sht,sthd->shd", w, v.float())
    return out.to(q.dtype)


def _registered_takes(q_shape, pool_shape, dtype, page_size) -> bool:
    """The JAX package's gate for a registered function, less its TPU
    backend test."""
    fn = _REGISTERED
    if fn is None or not get_flag("use_pallas_kernels"):
        return False
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if len(q_shape) != 3 or len(pool_shape) not in (4, 5):
        return False
    if q_shape[-1] % 128 or q_shape[-1] != pool_shape[-1] or page_size % 8:
        return False
    gate = getattr(fn, "supported", None)
    return gate is None or bool(gate(tuple(q_shape), tuple(pool_shape),
                                     dtype, page_size))


def paged_attention_supported(q_shape, kv_pool_shape, dtype, page_size,
                              device="cuda") -> bool:
    """Whether :func:`paged_attention` takes the call off the plain
    version (the JAX signature; ``device``, the card by default, is
    where the tensors lie): the CUDA kernel takes it, or a registered
    function does."""
    return (kernel_supported(q_shape, kv_pool_shape, dtype, page_size,
                             device)
            or _registered_takes(q_shape, kv_pool_shape, dtype,
                                 page_size))


def kernel_supported(q_shape, pool_shape, dtype, page_size,
                     device) -> bool:
    """Capability gate of the CUDA decode kernel (not profitability):
    ``FLAGS_use_pallas_kernels`` on, tensors on CUDA, f32 or bf16, q
    ``[S, H, D]`` over a 4-D ``[N, page, Hkv, D]`` or 5-D ``[L, N, page,
    Hkv, D]`` pool, ``D`` in the kernel's head dims and ``H / Hkv`` in its
    GQA groups.  ``page_size`` is any: the kernel walks pages of any
    length."""
    del page_size
    if not get_flag("use_pallas_kernels"):
        return False
    if torch.device(device).type != "cuda":
        return False
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if len(q_shape) != 3 or len(pool_shape) not in (4, 5):
        return False
    H, D = q_shape[1], q_shape[2]
    hkv = pool_shape[-2]
    if D != pool_shape[-1] or D not in SUPPORTED_HEAD_DIMS:
        return False
    return hkv > 0 and H % hkv == 0 and H // hkv in SUPPORTED_GROUPS


def paged_attention_select(q, k_pool, v_pool, page_table, lengths, *,
                           scale, layer=None):
    """The serving decode step's attention: the CUDA kernel where
    :func:`kernel_supported` takes the call, else a registered function
    where it takes the call, else the plain version (the CPU, the flag
    off, or a head dim or GQA group the kernel was not built for)."""
    q_shape, pool_shape = tuple(q.shape), tuple(k_pool.shape)
    page = int(pool_shape[-3])
    if kernel_supported(q_shape, pool_shape, q.dtype, page, q.device):
        return paged_attention_decode(q, k_pool, v_pool, page_table,
                                      lengths, scale=scale, layer=layer)
    fn = _REGISTERED
    if _registered_takes(q_shape, pool_shape, q.dtype, page):
        if _takes_layer(fn):
            return fn(q, k_pool, v_pool, page_table, lengths,
                      scale=float(scale), layer=layer)
        if layer is None:
            return fn(q, k_pool, v_pool, page_table, lengths,
                      scale=float(scale))
    return paged_attention_reference(q, k_pool, v_pool, page_table,
                                     lengths, scale=scale, layer=layer)


def _takes_layer(fn) -> bool:
    """Whether ``fn`` takes ``layer=`` (by its signature, as the JAX
    package decides it)."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return "layer" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def paged_attention(q, k_pool, v_pool, page_table, lengths, scale=None,
                    layer=None, name=None):
    """Decode-phase paged attention, one query token a sequence slot
    (the JAX package's public entry): :func:`paged_attention_select`
    with ``scale`` 1/sqrt(D) by default, recorded as the op
    ``paged_attention`` in a static Program."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return apply(paged_attention_select, q, k_pool, v_pool, page_table,
                 lengths, op_name="paged_attention",
                 attrs=dict(scale=float(scale), layer=layer))
