"""One ring chunk's matrix product (the counterpart of
``paddle_tpu/ops/pallas/collective_matmul.py``): the compute half of a
fused collective-matmul ring step.

- :func:`chunk_matmul_supported`: the JAX package's gate, kept as it
  is so both packages pick the kernel on the same shapes: 2-D
  ``[M, K] @ [K, Nc]`` with ``M % 8``, ``K % 128`` and ``Nc % 128``,
  f32 or bf16 operands.  (The CUDA kernel itself takes any M >= 1 and
  K % 32.)
- :func:`chunk_matmul_reference`: the plain version, ``x @ w`` summed in
  f32 and cast to ``result_type(x, w)``.
- :func:`chunk_matmul`: the hand-written CUDA kernel K6
  (:mod:`.cuda.chunk_matmul`) for CUDA tensors, the plain version for
  the others.  Mixed f32/bf16 operands are promoted to f32 first (exact),
  which is the JAX kernel's arithmetic for them.
"""
from __future__ import annotations

import torch

from .cuda import chunk_matmul as _cuda

__all__ = ["chunk_matmul", "chunk_matmul_supported",
           "chunk_matmul_reference"]

_LANES = 128
_SUBLANES = 8
_DTYPES = (torch.float32, torch.bfloat16)


def chunk_matmul_supported(x_shape, w_shape, x_dtype, w_dtype) -> bool:
    if len(x_shape) != 2 or len(w_shape) != 2:
        return False
    m, k = x_shape
    k2, nc = w_shape
    return (k == k2 and m % _SUBLANES == 0 and k % _LANES == 0
            and nc % _LANES == 0 and m > 0 and k > 0 and nc > 0
            and x_dtype in _DTYPES and w_dtype in _DTYPES)


def chunk_matmul_reference(x, w, out=None):
    y = torch.matmul(x.float(), w.float()).to(
        torch.result_type(x, w))
    if out is None:
        return y
    out.copy_(y)
    return out


def chunk_matmul(x, w, out=None):
    """``x @ w`` with f32 accumulation in ``result_type(x, w)``, into
    ``out`` when given (an ``[M, Nc]`` view, rows may be strided)."""
    if x.dtype != w.dtype:
        x, w = x.float(), w.float()
    if x.device.type == "cuda":
        return _cuda.chunk_matmul(x, w, out)
    return chunk_matmul_reference(x, w, out)
