"""Flash attention: softmax(q.k^T * scale) . v with a recompute-based
backward (the counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``).

Two versions of one function, chosen by where the tensors lie:

- the plain PyTorch versions :func:`flash_attention_reference_fwd` ->
  ``(out, lse)`` and :func:`flash_attention_reference_bwd` -> ``(dq, dk,
  dv)``, over ``[B, H, L, D]``: the CPU path and the oracle the CUDA
  kernels are held to.  The backward recomputes P from ``lse`` as the
  TPU kernel's ``_bwd`` does, with ``delta = rowsum(dO * O) - dlse``;
- the hand-written CUDA kernels of :mod:`.cuda.flash_attention`, for
  every CUDA tensor (shapes they do not take raise, never fall back).

:func:`flash_attention` is the public entry in JAX's ``[B, L, H, D]``
layout, differentiable through :class:`FlashAttention` (a
``torch.autograd.Function`` saving ``q, k, v, out, lse`` and the
dropout seed).  On the card the kernels read and write that layout in
place: no transposes around them.

:func:`flash_attention_block` is the ring-attention building block (JAX:
``flash_attention_block``, through ``_flash_with_lse``): attention of a
query block against a key block at global offsets, returning ``(out,
lse)`` with both differentiable (:class:`FlashAttentionBlock`; the lse
cotangent enters the backward as ``delta = rowsum(dO * O) - dlse``).

Dropout acts on the probabilities with the denominator undropped, so
E[out] is the undropped out.  The mask is a counter-based hash of
``(seed, b * H + h, query index, key index)``
(:func:`dropout_keep_mask`): the kernels and the plain version draw the
same mask whatever their tiling, bit for bit.  ``dropout_p == 0`` gives
exactly the undropped result; ``dropout_p >= 1`` drops everything.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.rng import dropout_threshold, fmix32, mul32
from .cuda import flash_attention as _cuda
from .cuda.flash_attention import SUPPORTED_HEAD_DIMS

__all__ = ["flash_attention", "flash_attention_supported",
           "flash_attention_reference_fwd", "flash_attention_reference_bwd",
           "attention_delta", "dropout_keep_mask", "mha_reference",
           "FlashAttention", "flash_attention_block", "FlashAttentionBlock",
           "plain_graph_grads", "flash_attention_fwd_op", "NEG_INF"]

NEG_INF = -1e30


def flash_attention_supported(q_shape, k_shape, dtype, attn_mask=None,
                              dropout_p: float = 0.0) -> bool:
    """Capability gate only: 4-D ``[B, L, H, D]``, f32 or bf16, no mask,
    ``D`` in the compiled set, k/v sharing q's batch, heads and ``D``.
    There is no profitability threshold: on the card every shape this
    takes goes to the kernels."""
    del dropout_p              # every rate is taken
    if attn_mask is not None or len(q_shape) != 4 or len(k_shape) != 4:
        return False
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    B, Lq, H, D = q_shape
    Bk, Lk, Hk, Dk = k_shape
    return ((Bk, Hk, Dk) == (B, H, D) and D in SUPPORTED_HEAD_DIMS
            and Lq >= 1 and Lk >= 1)


def dropout_keep_mask(seed: int, B: int, H: int, Lq: int, Lk: int,
                      dropout_p: float, device) -> Optional[torch.Tensor]:
    """The kernels' keep mask, bool ``[B, H, Lq, Lk]``, or None when
    nothing drops.  Per row: ``rk = fmix(fmix(seed * C1 ^ (b*H+h) * C2) ^
    q * C3)``; per key pair: ``x = fmix(rk ^ (k >> 1) * C4)``; key ``k``
    draws the low 16 bits of ``x`` when even, the high 16 when odd, and
    is kept iff the draw is ``>= round(p * 65536)``."""
    t, _ = dropout_threshold(dropout_p)
    if t == 0:
        return None
    i64 = dict(dtype=torch.int64, device=device)
    bh = torch.arange(B * H, **i64).reshape(B, H, 1, 1)
    q = torch.arange(Lq, **i64).reshape(1, 1, Lq, 1)
    k = torch.arange(Lk, **i64).reshape(1, 1, 1, Lk)
    s = int(seed) & 0xFFFFFFFF
    rk = fmix32(fmix32(mul32(torch.tensor(s, **i64), 0x9E3779B1)
                       ^ mul32(bh, 0x85EBCA77)) ^ mul32(q, 0xC2B2AE3D))
    x = fmix32(rk ^ mul32(k >> 1, 0x27D4EB2F))
    bits = torch.where((k & 1) == 1, x >> 16, x & 0xFFFF)
    return bits >= t


def _scores(q, k, scale, causal, q_off, k_off):
    """f32 scores [B, H, Lq, Lk] and the visibility mask (or None)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if not causal:
        return s, None
    Lq, Lk = q.shape[2], k.shape[2]
    qi = torch.arange(Lq, device=q.device)[:, None] + q_off
    kj = torch.arange(Lk, device=q.device)[None, :] + k_off
    visible = qi >= kj
    return s.masked_fill(~visible, NEG_INF), visible


def _dropped(p, seed, dropout_p):
    """``p`` with the kernels' dropout applied (kept values scaled)."""
    t, keep_scale = dropout_threshold(dropout_p)
    if t == 0:
        return p
    B, H, Lq, Lk = p.shape
    keep = dropout_keep_mask(seed, B, H, Lq, Lk, dropout_p, p.device)
    return torch.where(keep, p * keep_scale, torch.zeros_like(p))


def flash_attention_reference_fwd(q, k, v, causal: bool = False,
                                  scale: Optional[float] = None,
                                  dropout_p: float = 0.0, seed: int = 0,
                                  q_off: int = 0, k_off: int = 0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel over ``[B, H, L, D]``: ``out``
    in q's dtype and ``lse`` [B, H, Lq] f32, computed in f32.  Rows that
    see no key give out = 0 and lse = -1e30, as the kernel does."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s, visible = _scores(q, k, scale, causal, q_off, k_off)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if visible is not None:
        p = p * visible
    l = p.sum(dim=-1, keepdim=True)              # undropped denominator
    u = _dropped(p, seed, dropout_p)
    out = torch.einsum("bhqk,bhkd->bhqd", u, v.float()) / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, NEG_INF))
    return out.to(q.dtype), lse[..., 0]


def attention_delta(dout, out, dlse=None):
    """``rowsum(dout * out) - dlse`` over ``[B, H, Lq, D]`` (views do) as
    a contiguous [B, H, Lq] f32 tensor, the backward's correction term
    (``dlse`` is the cotangent of lse, if any)."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_attention_reference_bwd(q, k, v, out, lse, dout, dlse=None,
                                  causal: bool = False,
                                  scale: Optional[float] = None,
                                  dropout_p: float = 0.0, seed: int = 0,
                                  q_off: int = 0, k_off: int = 0):
    """Plain version of the backward kernels over ``[B, H, L, D]``:
    recompute P = exp(S - lse), regenerate the dropout mask, and
    dS = (U * dP - P * delta) * scale with U the dropped P."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = attention_delta(dout, out, dlse)
    s, visible = _scores(q, k, scale, causal, q_off, k_off)
    p = torch.exp(s - lse.float()[..., None])
    if visible is not None:
        p = p * visible
    u = _dropped(p, seed, dropout_p)
    do = dout.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", u, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v.float())
    ds = (u * dp - p * delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bhld(t):
    return t.transpose(1, 2)


def plain_graph_grads(kernel, inputs, plain_fwd, cotangents):
    """A hand kernel's backward run with grad mode on (a second
    derivative: ``grad(create_graph=True)``).  On CPU tensors: the
    gradients of ``plain_fwd(*inputs)`` (the outputs recomputed from the
    saved inputs, in the graph) against the inputs that require grad,
    taken with ``create_graph=True``, so a derivative of the gradients
    has every term.  On CUDA tensors it raises: the kernels compute
    first derivatives only, and a gradient that lacked the second-order
    terms would be wrong without an error."""
    if any(t.device.type == "cuda" for t in inputs):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no second derivative "
            f"(grad(create_graph=True) through it); take the gradient "
            f"without create_graph, or run the model on the CPU")
    need = [t.requires_grad for t in inputs]
    wrt = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        outs = plain_fwd(*inputs)
    pairs = [(o, c) for o, c in zip(outs, cotangents)
             if c is not None and o.requires_grad]
    if not wrt or not pairs:
        return [None] * len(inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [c for _, c in pairs], create_graph=True,
                                   allow_unused=True))
    return [next(got) if n else None for n in need]

@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cpu")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool, scale: float,
                           dropout_p: float, seed: int, q_off: int,
                           k_off: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of q/k/v ``[B, L, H, D]``; on the CPU the plain
    version."""
    out, lse = flash_attention_reference_fwd(
        _bhld(q), _bhld(k), _bhld(v), causal=causal, scale=scale,
        dropout_p=dropout_p, seed=seed, q_off=q_off, k_off=k_off)
    return _bhld(out).contiguous(), lse.contiguous()


@flash_attention_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, causal, scale, dropout_p, seed, q_off, k_off):
    return _cuda.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        scale=scale, dropout_p=dropout_p, seed=seed, q_off=q_off,
        k_off=k_off)


@flash_attention_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, dropout_p, seed, q_off, k_off):
    B, Lq, H, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((B, H, Lq), dtype=torch.float32))


class FlashAttention(torch.autograd.Function):
    """Flash attention over ``[B, L, H, D]`` with the kernels' backward:
    the CUDA kernels for CUDA tensors, the plain versions for the others
    (CPU tensors, and ``meta`` ones when a static program infers shapes).
    Saves ``(q, k, v, out, lse)``; the seed rides on ``ctx``.  The forward
    is :func:`flash_attention_fwd_op`.  A backward with grad mode on (a
    second derivative) goes through :func:`plain_graph_grads`: exact on
    the CPU, an error on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, seed):
        kw = dict(causal=causal, scale=scale, dropout_p=dropout_p, seed=seed)
        if q.device.type == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd_op(q, k, v, causal, scale, dropout_p,
                                          seed, 0, 0)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        kw = ctx.kw
        if torch.is_grad_enabled():
            dq, dk, dv = plain_graph_grads(
                "flash_attention", (q, k, v),
                lambda q, k, v: (_bhld(flash_attention_reference_fwd(
                    _bhld(q), _bhld(k), _bhld(v), **kw)[0]),), (dout,))
        elif q.device.type == "cuda":
            dout = dout.contiguous()
            delta = attention_delta(_bhld(dout), _bhld(out))
            dq = _cuda.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                              **kw)
            dk, dv = _cuda.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                   **kw)
        else:
            grads = flash_attention_reference_bwd(
                _bhld(q), _bhld(k), _bhld(v), _bhld(out), lse, _bhld(dout),
                **kw)
            dq, dk, dv = (_bhld(g).contiguous() for g in grads)
        return dq, dk, dv, None, None, None, None


class FlashAttentionBlock(torch.autograd.Function):
    """``(out, lse)`` of one query block against one key block, both
    differentiable: the CUDA kernels for CUDA tensors, the plain versions
    for the others.
    Saves ``(q, k, v, out, lse)``; a missing cotangent counts as zero.
    The forward is :func:`flash_attention_fwd_op`.  A second derivative
    goes through :func:`plain_graph_grads`."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, scale, causal):
        kw = dict(causal=causal, scale=scale, q_off=q_off, k_off=k_off)
        if q.device.type == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd_op(q, k, v, causal, scale, 0.0, 0,
                                          q_off, k_off)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        kw = ctx.kw
        if torch.is_grad_enabled():
            dq, dk, dv = plain_graph_grads(
                "flash_attention_block", (q, k, v),
                lambda q, k, v: _block_plain(q, k, v, kw), (dout, dlse))
            return dq, dk, dv, None, None, None, None
        if dout is None:
            dout = torch.zeros_like(out)
        if q.device.type == "cuda":
            dout = dout.contiguous()
            delta = attention_delta(_bhld(dout), _bhld(out), dlse)
            dq = _cuda.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                              **kw)
            dk, dv = _cuda.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                   **kw)
        else:
            grads = flash_attention_reference_bwd(
                _bhld(q), _bhld(k), _bhld(v), _bhld(out), lse, _bhld(dout),
                dlse, **kw)
            dq, dk, dv = (_bhld(g).contiguous() for g in grads)
        return dq, dk, dv, None, None, None, None


def _block_plain(q, k, v, kw):
    out, lse = flash_attention_reference_fwd(_bhld(q), _bhld(k), _bhld(v),
                                             **kw)
    return _bhld(out), lse


def flash_attention_block(q, k, v, q_off: int = 0, k_off: int = 0,
                          scale: Optional[float] = None,
                          causal: bool = True):
    """The ring-attention block: q ``[B, Lq, H, D]``, k/v ``[B, Lk, H,
    D]`` (the port's kernels' layout; the JAX entry takes ``[B, H, L,
    D]``) -> ``(out [B, Lq, H, D], lse [B, H, Lq] f32)``.

    ``causal``: key j is visible from query i iff ``q_off + i >= k_off +
    j`` (int offsets; the JAX entry takes f32 ``[1, 1]`` arrays and is
    always causal, reaching "every key visible" with ``k_off = -1e9``:
    here ``causal=False`` says it).  A row that sees no key gives out 0
    and lse -1e30 (:data:`NEG_INF`; the JAX kernel's rows give about
    -inf).  No dropout: rounds merge by lse, which needs undropped
    weights."""
    D = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    return FlashAttentionBlock.apply(q, k, v, int(q_off), int(k_off), scale,
                                     bool(causal))


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    seed: Optional[int] = None) -> torch.Tensor:
    """q/k/v: ``[B, L, H, D]`` -> ``[B, Lq, H, D]`` attention output.

    ``dropout_p > 0`` drops attention probabilities inside the kernel,
    keyed on the int32 ``seed`` (0 when None); pass a fresh seed per
    step (``core.rng.next_seed()``)."""
    D = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    seed = 0 if seed is None else int(seed)
    return FlashAttention.apply(q, k, v, bool(causal), scale,
                                float(dropout_p), seed)


def mha_reference(q, k, v, causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention oracle over ``[B, L, H, D]`` (f32 inside)."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        mask = torch.ones((Lq, Lk), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhls,bshd->blhd", w, v.float()).to(q.dtype)
