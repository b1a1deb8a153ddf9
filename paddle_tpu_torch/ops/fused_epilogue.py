"""Fused matmul epilogue: ``epilogue(x @ w)`` as one kernel, forward and
backward (the counterpart of ``paddle_tpu/ops/pallas/fused_epilogue.py``).

The epilogue is a static recipe of stages applied in order to the f32
accumulator of the product:

- ``("bias",)``: adds a consumed ``[N]`` operand;
- ``("relu",)`` / ``("gelu", approximate)``: activation;
- ``("add",)``: adds a consumed ``[M, N]`` residual operand;
- ``("layer_norm", eps, has_w, has_b)``: LayerNorm over each row,
  consuming the affine ``[N]`` operands its flags announce.

Two versions of one function, chosen by where the tensors lie:

- the plain PyTorch versions :func:`epilogue_forward_reference` and
  :func:`epilogue_backward_reference` (the TPU kernel's math: f32
  accumulator, the stages in f32, the backward replays the forward and
  walks the stages back, rounding the gradient at the accumulator to w's
  dtype before the products): the CPU path and the oracle the CUDA
  kernels are held to;
- the hand-written CUDA kernels of :mod:`.cuda.fused_epilogue` (K2f,
  K2b) for every CUDA tensor: shapes they do not take raise, never fall
  back.

:func:`fused_linear_epilogue` is the public entry (paddle_tpu's
signature), differentiable in x, w, bias and every operand through
:class:`FusedLinearEpilogue`.  :func:`reference_epilogue` is the unfused
composite the kernel replaces.  :func:`fused_epilogue_supported` is the
gate the static Executor's fusion pass asks.

The forward is one ``torch.library`` custom op,
``paddle_tpu_torch::fused_linear_epilogue_fwd``
(:func:`fused_linear_epilogue_fwd_op`, the recipe passed as its
``repr``): the CUDA implementation launches K2f, the CPU one is the plain
version, chosen by the tensors' device when the op runs, so a graph
captured by ``torch.export`` keeps the kernel as one node.
"""
from __future__ import annotations

import ast
import functools
import math
from typing import List

import torch
import torch.nn.functional as TF

from ..core.dtype import convert_dtype
from .cuda import fused_epilogue as _cuda
from .cuda.fused_epilogue import MAX_LN_N, ops_per_stage
from .flash_attention import plain_graph_grads

__all__ = ["fused_linear_epilogue", "fused_epilogue_supported",
           "reference_epilogue", "epilogue_forward_reference",
           "epilogue_backward_reference", "stage_label",
           "FusedLinearEpilogue", "fused_linear_epilogue_fwd_op"]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_INV_SQRT_2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def stage_label(stages) -> str:
    """Kernel name for records: ``matmul+bias+gelu`` and the like."""
    return "+".join(["matmul"] + [s[0] for s in stages])


def fused_epilogue_supported(x_shape, w_shape, dtype, stages=(),
                             operand_shapes=()) -> bool:
    """Capability gate, the same on every device so that selection is
    deterministic: f32/bf16, rows % 8, K % 8, N % 128 (paddle_tpu's
    conditions), every operand the ``[N]`` vector or the full ``[M, N]``
    residual its stage expects; and the card's own: at most one
    layer_norm stage, over at most ``MAX_LN_N`` columns.  paddle_tpu's
    cap on the weight (4 MB for its VMEM) has no counterpart here."""
    try:
        dtype = convert_dtype(dtype)
    except (ValueError, TypeError):
        return False
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if len(w_shape) != 2 or len(x_shape) < 2:
        return False
    k, n = int(w_shape[0]), int(w_shape[1])
    if int(x_shape[-1]) != k:
        return False
    m = math.prod(int(s) for s in x_shape[:-1])
    if m <= 0 or m % 8 or k % 8 or n % 128:
        return False
    n_ln = 0
    oi = 0
    for st in stages:
        kind = st[0]
        if kind not in ("bias", "relu", "gelu", "add", "layer_norm"):
            return False
        n_ln += kind == "layer_norm"
        for _ in range(ops_per_stage(st)):
            if oi >= len(operand_shapes):
                return False
            shp = tuple(int(s) for s in operand_shapes[oi])
            oi += 1
            if kind == "add":
                if not shp or shp[-1] != n or math.prod(shp[:-1]) != m:
                    return False
            elif shp != (n,) and shp != (1, n):
                return False
    if n_ln > 1 or (n_ln and n > MAX_LN_N):
        return False
    return oi == len(operand_shapes)


# ------------------------------------------------------- the plain math
def _gelu_f32(z, approximate):
    if approximate:
        u = _SQRT_2_OVER_PI * (z + 0.044715 * z * z * z)
        return 0.5 * z * (1.0 + torch.tanh(u))
    return 0.5 * z * (1.0 + torch.erf(z * _INV_SQRT_2))


def _dgelu_f32(z, approximate):
    if approximate:
        u = _SQRT_2_OVER_PI * (z + 0.044715 * z * z * z)
        t = torch.tanh(u)
        du = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * z * z)
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du
    cdf = 0.5 * (1.0 + torch.erf(z * _INV_SQRT_2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * z * z)
    return cdf + z * pdf


def _ln_stats(h, eps):
    mu = h.mean(dim=-1, keepdim=True)
    d = h - mu
    rstd = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + eps)
    return d * rstd, rstd


def _apply_stages(z, stages, vals):
    """The recipe over the f32 accumulator; ``vals`` are the operands in
    f32.  Returns (result, the input of each stage)."""
    it = iter(vals)
    hs = []
    for st in stages:
        hs.append(z)
        kind = st[0]
        if kind in ("bias", "add"):
            z = z + next(it)
        elif kind == "relu":
            z = torch.clamp_min(z, 0.0)
        elif kind == "gelu":
            z = _gelu_f32(z, st[1])
        elif kind == "layer_norm":
            z, _ = _ln_stats(z, st[1])
            if st[2]:
                z = z * next(it)
            if st[3]:
                z = z + next(it)
    return z, hs


def epilogue_forward_reference(x, w, ops, stages):
    """Plain version of the forward kernel: x [M, K], w [K, N], operands
    ``[1, N]`` / ``[M, N]`` -> ``[M, N]`` in x's dtype."""
    z = x.float() @ w.float()
    z, _ = _apply_stages(z, stages, [o.float() for o in ops])
    return z.to(x.dtype)


def epilogue_backward_reference(x, w, ops, stages, dy):
    """Plain version of the backward kernels: replay the forward, walk
    the stages back from ``dy`` -> ``(dx, dw, dops)`` in the dtypes of
    x, w and each operand."""
    slots, oi = [], 0
    for st in stages:
        cnt = ops_per_stage(st)
        slots.append(tuple(range(oi, oi + cnt)))
        oi += cnt
    vals = [o.float() for o in ops]
    z = x.float() @ w.float()
    _, hs = _apply_stages(z, stages, vals)
    grads = [None] * len(ops)
    g = dy.float()
    for st, h_in, sl in reversed(list(zip(stages, hs, slots))):
        kind = st[0]
        if kind == "bias":
            grads[sl[0]] = g.sum(dim=0, keepdim=True)
        elif kind == "add":
            grads[sl[0]] = g
        elif kind == "relu":
            g = torch.where(h_in > 0.0, g, torch.zeros_like(g))
        elif kind == "gelu":
            g = g * _dgelu_f32(h_in, st[1])
        elif kind == "layer_norm":
            _, eps, has_w, has_b = st
            xhat, rstd = _ln_stats(h_in, eps)
            if has_b:
                grads[sl[int(bool(has_w))]] = g.sum(dim=0, keepdim=True)
            if has_w:
                grads[sl[0]] = (g * xhat).sum(dim=0, keepdim=True)
                g = g * vals[sl[0]]
            g = rstd * (g - g.mean(dim=-1, keepdim=True)
                        - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dx = (g.to(w.dtype).float() @ w.float().t()).to(x.dtype)
    dw = (x.float().t() @ g.to(x.dtype).float()).to(w.dtype)
    return dx, dw, [gr.to(o.dtype) for gr, o in zip(grads, ops)]


# ------------------------------------------------------ the forward op
@functools.lru_cache(maxsize=None)
def _stages_of(recipe: str):
    return ast.literal_eval(recipe)


@torch.library.custom_op("paddle_tpu_torch::fused_linear_epilogue_fwd",
                         mutates_args=(), device_types="cpu")
def fused_linear_epilogue_fwd_op(x2: torch.Tensor, w: torch.Tensor,
                                 ops: List[torch.Tensor],
                                 recipe: str) -> torch.Tensor:
    """``epilogue(x2 @ w)``, x2 [M, K], with the stages of ``recipe``
    (``repr`` of the stage tuple); on the CPU the plain version."""
    return epilogue_forward_reference(x2, w, ops, _stages_of(recipe))


@fused_linear_epilogue_fwd_op.register_kernel("cuda")
def _epilogue_fwd_cuda(x2, w, ops, recipe):
    return _cuda.fused_epilogue_fwd(x2.contiguous(), w.contiguous(),
                                    tuple(o.contiguous() for o in ops),
                                    _stages_of(recipe))


@fused_linear_epilogue_fwd_op.register_fake
def _epilogue_fwd_fake(x2, w, ops, recipe):
    return x2.new_empty((x2.shape[0], w.shape[1]))


# ------------------------------------------------ the autograd Function
class FusedLinearEpilogue(torch.autograd.Function):
    """``epilogue(x2 @ w)`` over 2-D x2 with the kernels' backward: the
    CUDA kernels for CUDA tensors, the plain versions for the others.
    Saves ``(x2, w, *ops)``: the backward recomputes the rest.  The
    forward is :func:`fused_linear_epilogue_fwd_op`.  A second
    derivative goes through
    :func:`~.flash_attention.plain_graph_grads`: exact on the CPU, an
    error on the card."""

    @staticmethod
    def forward(ctx, x2, w, stages, *ops):
        if x2.device.type == "cuda":
            x2, w = x2.contiguous(), w.contiguous()
            ops = tuple(o.contiguous() for o in ops)
        out = fused_linear_epilogue_fwd_op(x2, w, list(ops), repr(stages))
        ctx.save_for_backward(x2, w, *ops)
        ctx.stages = stages
        return out

    @staticmethod
    def backward(ctx, dy):
        x2, w, *ops = ctx.saved_tensors
        if torch.is_grad_enabled():
            stages = ctx.stages
            dx, dw, *dops = plain_graph_grads(
                "fused_linear_epilogue", (x2, w, *ops),
                lambda x2, w, *ops: (epilogue_forward_reference(
                    x2, w, ops, stages),), (dy,))
        elif x2.device.type == "cuda":
            dx, dw, dops = _cuda.fused_epilogue_bwd(x2, w, ops, ctx.stages,
                                                    dy.contiguous())
        else:
            dx, dw, dops = epilogue_backward_reference(x2, w, ops,
                                                       ctx.stages, dy)
        return (dx, dw, None, *dops)


def fused_linear_epilogue(x, w, bias=None, stages=(), operands=()):
    """``epilogue(x @ w (+ bias))`` as one kernel.

    ``x``: [..., K]; ``w``: [K, N]; ``stages``: the recipe after the bias
    (see the module docstring); ``operands``: the tensors the ``add`` and
    ``layer_norm`` stages consume, in order (``[N]`` vectors or
    ``[..., N]`` residuals matching x's leading dims).  Leading dims
    flatten into rows around the kernel."""
    k, n = int(w.shape[0]), int(w.shape[1])
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    stages_full = tuple(stages)
    ops = []
    if bias is not None:
        stages_full = (("bias",),) + stages_full
        ops.append(bias.reshape(1, n))
    it = iter(operands)
    for st in tuple(stages):
        for _ in range(ops_per_stage(st)):
            o = next(it)
            ops.append(o.reshape(1, n) if o.dim() == 1
                       or tuple(o.shape) == (1, n) else o.reshape(m, n))
    out = FusedLinearEpilogue.apply(x2, w, stages_full, *ops)
    return out.reshape(*lead, n)


def reference_epilogue(x, w, bias=None, stages=(), operands=()):
    """The unfused composite (PyTorch's own ops), any device."""
    z = torch.matmul(x, w)
    if bias is not None:
        z = z + bias
    it = iter(operands)
    for st in stages:
        kind = st[0]
        if kind == "relu":
            z = torch.relu(z)
        elif kind == "gelu":
            z = TF.gelu(z, approximate="tanh" if st[1] else "none")
        elif kind in ("add", "bias"):
            z = z + next(it)
        elif kind == "layer_norm":
            _, eps, has_w, has_b = st
            z = TF.layer_norm(z, (z.shape[-1],), next(it) if has_w else None,
                              next(it) if has_b else None, eps)
    return z
