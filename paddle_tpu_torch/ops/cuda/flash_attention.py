"""Flash attention on Hopper: the wrappers of ``csrc/flash_attention.cu``.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas/flash_attention.py``:
``_fwd`` (body ``_fwd_kernel``) and ``_bwd`` (bodies ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel``).  Three kernels, three launch counts:

- :func:`flash_attention_fwd` -> ``(out, lse)``, counted under
  ``flash_attention_fwd``;
- :func:`flash_attention_bwd_dq` -> ``dq``, ``flash_attention_bwd_dq``;
- :func:`flash_attention_bwd_dkv` -> ``(dk, dv)``,
  ``flash_attention_bwd_dkv``.

**Layout.** The wrappers take JAX's public ``[B, L, H, D]``, each
tensor contiguous: the projections' outputs as they are.  The kernels
read and write through strides (at bf16, TMA reads through rank-4
tensor maps over the same layout), so there are no transposes around
them; ``lse`` and ``delta`` are ``[B, H, Lq]`` f32.

**Two designs, one per dtype.** bf16 runs on the tensor cores: wgmma
fed by TMA, two warpgroups a block (``flash_*_wgmma_kernel``).  f32
stays exact f32 on the CUDA cores (wgmma has no exact f32 mode): the
forward in the ``mma.sync`` fragment layout by FMA (``flash_fwd_kernel``),
the backward on register tiles of outer products
(``flash_bwd_{dq,dkv}_f32_kernel``).

**Causal masking** uses global offsets: key ``j`` is visible from query
``i`` iff ``q_off + i >= k_off + j`` (the JAX kernel's float offsets
become ints).  **Dropout** follows the TPU kernel's quantised rule
(:func:`~paddle_tpu_torch.core.rng.dropout_threshold`) with a per-element
counter-based hash of ``(seed, b * H + h, i, j)``;
``ops.flash_attention.dropout_keep_mask`` is the same mask in PyTorch.

**Bound:** nearly balanced between bytes and tensor-core operations at
BERT-base shapes; the source file says more.

Every tensor must be a CUDA tensor the kernels take (f32 or bf16,
``D`` in :data:`SUPPORTED_HEAD_DIMS`, 16-byte aligned); anything else
raises ``ValueError``.
"""
from __future__ import annotations

import torch

from ...core.rng import dropout_threshold
from . import support

__all__ = ["flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "SUPPORTED_HEAD_DIMS", "KERNELS"]

KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv")
# the head dims csrc/flash_attention.cu compiles, at f32 and bf16
SUPPORTED_HEAD_DIMS = (32, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _strides(B, H, L, D):
    """Element strides (b, h, l) of a contiguous [B, L, H, D] tensor."""
    return L * H * D, D, H * D


def _check(fn, q, k, v, dout=None, lse=None, delta=None):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{fn}: q, k and v must be 4-D [B, L, H, D]")
    B, Lq, H, D = q.shape
    Bk, Lk, Hk, Dk = k.shape
    if (Bk, Hk, Dk) != (B, H, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} disagree")
    four = [("q", q, q.shape), ("k", k, k.shape), ("v", v, k.shape)]
    if dout is not None:
        four.append(("dout", dout, q.shape))
    for name, t, want in four:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected the "
                             f"CUDA device {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{fn}: {name} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")
    if not support.dtype_ok(q.dtype):
        raise ValueError(f"{fn}: dtype {q.dtype} (f32 or bf16 only)")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if not (1 <= B <= 65535 and 1 <= H <= 65535 and Lq >= 1 and Lk >= 1):
        raise ValueError(f"{fn}: B and H must lie in [1, 65535] and both "
                         f"lengths be >= 1 (B={B} H={H} Lq={Lq} Lk={Lk})")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (B, H, Lq) or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous f32 "
                             f"[B, H, Lq] = [{B}, {H}, {Lq}] tensor on "
                             f"{q.device}")
    return B, H, Lq, Lk, D


def _common(q, B, H, Lq, Lk, D, scale, causal, q_off, k_off, seed,
            dropout_p):
    """The scalar tail of every entry point's C arguments."""
    t, _ = dropout_threshold(dropout_p)
    return (B, H, Lq, Lk, D, *_strides(B, H, Lq, D),
            *_strides(B, H, Lk, D), float(scale), int(bool(causal)),
            int(q_off), int(k_off), int(seed) & 0xFFFFFFFF, t,
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(rc, fn):
    if rc != 0:
        raise RuntimeError(f"{fn}: launch failed (code {rc})")


def flash_attention_fwd(q, k, v, *, scale: float, causal: bool = False,
                        dropout_p: float = 0.0, seed: int = 0,
                        q_off: int = 0, k_off: int = 0):
    """softmax(q.k^T * scale) . v on the card -> ``(out, lse)``:
    q, k, v ``[B, L, H, D]``; ``out`` like ``q``, ``lse`` [B, H, Lq] f32
    (-1e30 on rows that see no key)."""
    fn = KERNELS[0]
    B, H, Lq, Lk, D = _check(fn, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    lib = support.load_library()
    rc = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(),
                           *_common(q, B, H, Lq, Lk, D, scale,
                                    causal, q_off, k_off, seed, dropout_p))
    _raise_on(rc, fn)
    support.count_launch(fn)
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, scale: float,
                           causal: bool = False, dropout_p: float = 0.0,
                           seed: int = 0, q_off: int = 0, k_off: int = 0):
    """dQ of flash attention on the card.  ``delta`` is
    ``rowsum(dout * out) - dlse`` ([B, H, Lq] f32), computed by the
    caller; ``lse`` is the forward's."""
    fn = KERNELS[1]
    B, H, Lq, Lk, D = _check(fn, q, k, v, dout, lse=lse,
                             delta=delta)
    dq = torch.empty_like(q)
    lib = support.load_library()
    rc = lib.ptt_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(),
                              *_common(q, B, H, Lq, Lk, D, scale,
                                       causal, q_off, k_off, seed,
                                       dropout_p))
    _raise_on(rc, fn)
    support.count_launch(fn)
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, scale: float,
                            causal: bool = False, dropout_p: float = 0.0,
                            seed: int = 0, q_off: int = 0, k_off: int = 0):
    """(dK, dV) of flash attention on the card; arguments as
    :func:`flash_attention_bwd_dq`."""
    fn = KERNELS[2]
    B, H, Lq, Lk, D = _check(fn, q, k, v, dout, lse=lse,
                             delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = support.load_library()
    rc = lib.ptt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(),
                               *_common(q, B, H, Lq, Lk, D,
                                        scale, causal, q_off, k_off, seed,
                                        dropout_p))
    _raise_on(rc, fn)
    support.count_launch(fn)
    return dk, dv
