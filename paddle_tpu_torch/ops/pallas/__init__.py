"""``paddle_tpu.ops.pallas``'s names over the port's hand-written CUDA
kernels (the JAX package's Pallas tier), in the JAX signatures.

- ``flash_attention`` / ``flash_attention_supported`` /
  ``mha_reference``: K1f and K1b (``ops.flash_attention``);
- ``fused_adam_supported`` / ``fused_adam_update``: K3;
- ``fused_epilogue_supported`` / ``fused_linear_epilogue`` /
  ``reference_epilogue``: K2f and K2b;
- ``paged_attention_decode`` / ``paged_decode_supported``: K4;
- ``kernel_selections``: launches by kernel name, the dict the wrappers
  count into (``ops.cuda.support.launch_counts``; the JAX package counts
  selections at trace time, the port counts launches).

``block_q`` / ``block_k`` are taken and ignored: the card's tiles are
fixed per instance.  ``interpret=True`` asks for the plain version: on
a CPU tensor that is what runs, and on a CUDA tensor it raises (the
CUDA kernels have no interpret mode and the card takes no fallback).
Otherwise the tensors' device decides: a CUDA tensor launches the
kernel or raises, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import math

from .. import attention as _attention
from .. import flash_attention as _flash
from .. import fused_adam as _adam
from .. import fused_epilogue as _epilogue
from ..cuda import paged_attention as _paged
from ..cuda import support as _support

__all__ = ["flash_attention", "flash_attention_supported", "mha_reference",
           "fused_adam_supported", "fused_adam_update",
           "fused_epilogue_supported", "fused_linear_epilogue",
           "reference_epilogue", "paged_attention_decode",
           "paged_decode_supported", "kernel_selections"]

kernel_selections = _support.launch_counts
mha_reference = _flash.mha_reference
fused_adam_supported = _adam.fused_adam_supported
fused_epilogue_supported = _epilogue.fused_epilogue_supported
reference_epilogue = _epilogue.reference_epilogue


def _no_interpret_on_card(name, interpret, tensor):
    if interpret and tensor.device.type == "cuda":
        raise ValueError(
            f"{name}(interpret=True) on a CUDA tensor: the CUDA kernel has "
            f"no interpret mode; pass CPU tensors for the plain version")


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None, dropout_p=0.0, seed=None):
    """``[B, L, H, D]`` attention through K1f/K1b (``block_q`` and
    ``block_k`` ignored)."""
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                  dropout_p=dropout_p, seed=seed)


def flash_attention_supported(q_shape, k_shape, dtype, attn_mask=None,
                              dropout_p=0.0, block_q=None, block_k=None):
    return _flash.flash_attention_supported(q_shape, k_shape, dtype,
                                            attn_mask, dropout_p)


def fused_adam_update(p, g, m, v, lr, step, *, beta1=0.9, beta2=0.999,
                      eps=1e-8, interpret=None):
    """One Adam step of one f32 tensor -> new ``(p, m, v)`` (K3)."""
    _no_interpret_on_card("fused_adam_update", interpret, p)
    return _adam.fused_adam_update(p, g, m, v, lr, step, beta1=beta1,
                                   beta2=beta2, eps=eps)


def fused_linear_epilogue(x, w, bias=None, stages=(), operands=(),
                          interpret=None):
    """``epilogue(x @ w (+ bias))``, differentiable (K2f, K2b)."""
    _no_interpret_on_card("fused_linear_epilogue", interpret, x)
    return _epilogue.fused_linear_epilogue(x, w, bias, stages, operands)


def paged_attention_decode(q, k_pool, v_pool, page_table, lengths,
                           scale=None, layer=None, interpret=None):
    """Decode attention over a paged KV pool: K4 on CUDA tensors (shapes
    it does not take raise), the plain version on CPU tensors."""
    _no_interpret_on_card("paged_attention_decode", interpret, q)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _paged.paged_attention_decode(q, k_pool, v_pool, page_table,
                                             lengths, scale=scale,
                                             layer=layer)
    return _attention.paged_attention_reference(
        q, k_pool, v_pool, page_table, lengths, scale=scale, layer=layer)


def paged_decode_supported(q_shape, kv_pool_shape, dtype, page_size):
    """Whether K4 takes these shapes on the card."""
    return _attention.kernel_supported(q_shape, kv_pool_shape, dtype,
                                       page_size, "cuda")
