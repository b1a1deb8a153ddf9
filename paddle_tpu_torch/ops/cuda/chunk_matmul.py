"""K6 on Hopper: the wrapper of ``csrc/chunk_matmul.cu``.

Replaces the TPU kernel of ``paddle_tpu/ops/pallas/collective_matmul.py``
(``chunk_matmul``, body ``_mm_kernel``): one ring chunk's ``x @ w`` with
f32 accumulation, stored in the operands' dtype.  Counted under
``chunk_matmul``.

``out``, when given, is where the product goes: an ``[M, N]`` view
whose rows may be strided (a column block of a wider output), so the
column-parallel ring writes each chunk in place.  ``x`` may be a
row-strided view too (a slice of the activations' columns).

Every tensor must be on one CUDA device, f32 or bf16 (one dtype for
all), 2-D with unit stride along its rows, 16-byte aligned, with K a
multiple of 32 and N of 128; anything else raises ``ValueError``.
"""
from __future__ import annotations

import torch

from . import support

__all__ = ["chunk_matmul", "KERNEL"]

KERNEL = "chunk_matmul"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, w, out):
    fn = KERNEL
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{fn}: x and w must be 2-D, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"do not chain")
    if M < 1 or K % 32 or N % 128 or K < 32 or N < 128:
        raise ValueError(f"{fn}: shape M={M} K={K} N={N}: M >= 1, K a "
                         f"multiple of 32 and N a multiple of 128 only")
    if not support.dtype_ok(x.dtype) or w.dtype != x.dtype:
        raise ValueError(f"{fn}: dtypes {x.dtype} and {w.dtype} (f32 or "
                         f"bf16, the same for both)")
    vec = 16 // x.element_size()
    for name, t in (("x", x), ("w", w), ("out", out)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected the "
                             f"CUDA device {x.device}")
        if t.stride(1) != 1 or t.stride(0) % vec or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} needs unit stride along its "
                             f"rows, a row stride that is a multiple of "
                             f"{vec} and 16-byte alignment")
    if out.dtype != x.dtype or tuple(out.shape) != (M, N):
        raise ValueError(f"{fn}: out is {out.dtype} {tuple(out.shape)}, "
                         f"expected {x.dtype} {(M, N)}")
    return M, K, N


def chunk_matmul(x, w, out=None):
    """``x @ w`` on the card (f32 accumulation) into ``out`` (allocated
    when None); returns ``out``."""
    if out is None:
        out = torch.empty((x.shape[0], w.shape[-1]), dtype=x.dtype,
                          device=x.device)
    M, K, N = _check(x, w, out)
    lib = support.load_library()
    rc = lib.ptt_chunk_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              M, K, N, x.stride(0), w.stride(0),
                              out.stride(0), _DTYPE_CODE[x.dtype],
                              torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL}: launch failed (code {rc})")
    support.count_launch(KERNEL)
    return out
