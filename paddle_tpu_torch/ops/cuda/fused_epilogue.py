"""The fused matmul epilogue on Hopper: the wrappers of
``csrc/fused_epilogue.cu``.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas/fused_epilogue.py``:
``_fwd`` (body from ``_make_fwd_kernel``) and ``_bwd_call`` (body from
``_make_bwd_kernel``).  Three kernels, three launch counts:

- :func:`fused_epilogue_fwd` -> ``out``, counted under
  ``fused_epilogue_fwd``;
- :func:`fused_epilogue_bwd` -> ``(dx, dw, dops)``: two launches,
  :func:`fused_epilogue_bwd_rows` (counted under ``fused_epilogue_bwd``:
  recompute, walk the stages back, write g, the d-residuals and
  per-block sums) and :func:`fused_epilogue_bwd_grads`
  (``fused_epilogue_bwd_grads``: dx = g.w^T, dw = x^T.g and the sums of
  the vector operands' gradients).

A recipe is paddle_tpu's: a tuple of stages applied in order to the f32
accumulator, ``("bias",)``, ``("relu",)``, ``("gelu", approximate)``,
``("add",)``, ``("layer_norm", eps, has_w, has_b)``, with ``ops`` the
operands they consume in order (``[1, N]`` vectors, ``[M, N]``
residuals).  On this card a recipe takes at most one ``layer_norm``,
and a ``layer_norm`` recipe at most :data:`MAX_LN_N` columns: at f32 the
forward joins a row over a cluster of N / 128 blocks (12 at most), at
bf16 and in the backward one block keeps its rows whole in shared
memory.

Every tensor must be a contiguous, 16-byte aligned CUDA tensor the
kernels take (x and w of one dtype, f32 or bf16; K a multiple of 8 and
N of 128, as the gate asks); anything else raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import support

__all__ = ["fused_epilogue_fwd", "fused_epilogue_bwd",
           "fused_epilogue_bwd_rows", "fused_epilogue_bwd_grads",
           "ops_per_stage", "MAX_LN_N", "KERNELS"]

KERNELS = ("fused_epilogue_fwd", "fused_epilogue_bwd",
           "fused_epilogue_bwd_grads")
# the widest layer_norm row: a cluster of 12 blocks (f32 forward), or
# 32 x 1536 f32 rows in one block's shared memory (bf16, backward)
MAX_LN_N = 1536
_MAX_STAGES = 8
_CODES = {"bias": 0, "relu": 1, "gelu": 2, "add": 3, "layer_norm": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROWS, _ROW_GROUPS = 32, 2          # csrc: kBM, kRowGroups


def ops_per_stage(stage) -> int:
    """How many operands a stage consumes (in order)."""
    kind = stage[0]
    if kind in ("bias", "add"):
        return 1
    if kind == "layer_norm":
        return int(bool(stage[2])) + int(bool(stage[3]))
    return 0


def _check(fn, x, w, ops, stages, dy=None):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{fn}: x must be [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k, n = x.shape[0], x.shape[1], w.shape[1]
    if m < 1 or k < 8 or k % 8 or n % 128 or n < 128:
        raise ValueError(f"{fn}: needs M >= 1, K a multiple of 8 and N a "
                         f"multiple of 128 (M={m} K={k} N={n})")
    named = [("x", x), ("w", w)] + ([("dy", dy)] if dy is not None else [])
    for name, t in named + [(f"operand {i}", o) for i, o in enumerate(ops)]:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected the "
                             f"CUDA device {x.device}")
        if not support.dtype_ok(t.dtype):
            raise ValueError(f"{fn}: {name} dtype {t.dtype} (f32 or bf16 "
                             f"only)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte "
                             f"aligned")
    if w.dtype != x.dtype or (dy is not None and dy.dtype != x.dtype):
        raise ValueError(f"{fn}: x, w and dy must share one dtype")
    if dy is not None and tuple(dy.shape) != (m, n):
        raise ValueError(f"{fn}: dy has shape {tuple(dy.shape)}, expected "
                         f"{(m, n)}")
    if len(stages) > _MAX_STAGES or len(ops) > _MAX_STAGES:
        raise ValueError(f"{fn}: at most {_MAX_STAGES} stages and operands")
    n_ln = sum(st[0] == "layer_norm" for st in stages)
    if n_ln > 1 or (n_ln and n > MAX_LN_N):
        raise ValueError(f"{fn}: at most one layer_norm stage, over at most "
                         f"{MAX_LN_N} columns (N={n})")
    slot = 0
    for st in stages:
        if st[0] not in _CODES:
            raise ValueError(f"{fn}: unknown stage {st!r}")
        for _ in range(ops_per_stage(st)):
            if slot >= len(ops):
                raise ValueError(f"{fn}: the recipe needs more operands "
                                 f"than the {len(ops)} given")
            want = (m, n) if st[0] == "add" else (1, n)
            if tuple(ops[slot].shape) != want:
                raise ValueError(f"{fn}: operand {slot} of stage {st[0]} "
                                 f"has shape {tuple(ops[slot].shape)}, "
                                 f"expected {want}")
            slot += 1
    if slot != len(ops):
        raise ValueError(f"{fn}: {len(ops)} operands for a recipe that "
                         f"consumes {slot}")


def _op_info(ops):
    """(full, bf16) per operand, as a C int array."""
    info: List[int] = []
    for o in ops:
        info += [int(o.shape[0] != 1), _DTYPE_CODE[o.dtype]]
    return (ctypes.c_int * len(info))(*info)


def _recipe(stages, ops):
    """The C arguments of a recipe: codes (kind, approx, op0, op1 per
    stage), eps, operand pointers and (full, bf16) per operand."""
    codes: List[int] = []
    eps: List[float] = []
    slot = 0
    for st in stages:
        kind = st[0]
        approx, op0, op1, e = 0, -1, -1, 0.0
        if kind in ("bias", "add"):
            op0 = slot
        elif kind == "gelu":
            approx = int(bool(st[1]))
        elif kind == "layer_norm":
            e = float(st[1])
            op0 = slot if st[2] else -1
            op1 = slot + int(bool(st[2])) if st[3] else -1
        codes += [_CODES[kind], approx, op0, op1]
        eps.append(e)
        slot += ops_per_stage(st)
    return ((ctypes.c_int * len(codes))(*codes),
            (ctypes.c_float * len(eps))(*eps), len(stages),
            (ctypes.c_void_p * len(ops))(*[o.data_ptr() for o in ops]),
            _op_info(ops), len(ops))


def _raise_on(rc, fn):
    if rc != 0:
        raise RuntimeError(f"{fn}: launch failed (code {rc})")


def fused_epilogue_fwd(x: torch.Tensor, w: torch.Tensor,
                       ops: Sequence[torch.Tensor], stages) -> torch.Tensor:
    """``epilogue(x @ w)`` on the card: x [M, K], w [K, N] -> [M, N] in
    x's dtype."""
    fn = KERNELS[0]
    _check(fn, x, w, ops, stages)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    codes, eps, n_st, ptrs, info, n_ops = _recipe(stages, ops)
    lib = support.load_library()
    rc = lib.ptt_epilogue_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              m, k, n, codes, eps, n_st, ptrs, info, n_ops,
                              _DTYPE_CODE[x.dtype],
                              torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, fn)
    support.count_launch(fn)
    return out


def fused_epilogue_bwd_rows(x, w, ops, stages, dy):
    """The first backward kernel: recompute the accumulator, walk the
    stages back from ``dy`` -> ``(g, partial, dres)``: g at the
    accumulator in w's dtype [M, N], the per-block f32 sums of the
    vector operands' gradients [row groups, n_ops, N], and the
    residual operands' gradients (None for vector operands)."""
    fn = KERNELS[1]
    _check(fn, x, w, ops, stages, dy)
    m, k = x.shape
    n = w.shape[1]
    dev = x.device
    g = torch.empty((m, n), dtype=w.dtype, device=dev)
    partial = torch.empty((-(-m // _ROWS) * _ROW_GROUPS, max(len(ops), 1),
                           n), dtype=torch.float32, device=dev)
    dres = [torch.empty_like(o) if o.shape[0] != 1 else None for o in ops]
    codes, eps, n_st, ptrs, info, n_ops = _recipe(stages, ops)
    grads = (ctypes.c_void_p * len(ops))(
        *[None if d is None else d.data_ptr() for d in dres])
    lib = support.load_library()
    rc = lib.ptt_epilogue_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                              g.data_ptr(), partial.data_ptr(), m, k, n,
                              codes, eps, n_st, ptrs, grads, info, n_ops,
                              _DTYPE_CODE[x.dtype],
                              torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, fn)
    support.count_launch(fn)
    return g, partial, dres


def fused_epilogue_bwd_grads(x, w, ops, g, partial):
    """The second backward kernel: ``dx = g . w^T`` (x's dtype), ``dw =
    x^T . g`` (f32) and the vector operands' gradients summed over the
    row blocks in order (f32 [n_ops, N]) -> ``(dx, dw, dvec)``."""
    fn = KERNELS[2]
    m, k = x.shape
    n = w.shape[1]
    dev = x.device
    want = (-(-m // _ROWS) * _ROW_GROUPS, max(len(ops), 1), n)
    if dev.type != "cuda" or any(t.device != dev for t in (w, g, partial)):
        raise ValueError(f"{fn}: x, w, g and partial must be on one CUDA "
                         f"device")
    if (g.shape != (m, n) or g.dtype != w.dtype
            or tuple(partial.shape) != want or not g.is_contiguous()):
        raise ValueError(f"{fn}: g or partial do not come from "
                         f"fused_epilogue_bwd_rows for these shapes")
    dx = torch.empty_like(x)
    dw = torch.empty((k, n), dtype=torch.float32, device=dev)
    dvec = torch.empty((max(len(ops), 1), n), dtype=torch.float32,
                       device=dev)
    lib = support.load_library()
    rc = lib.ptt_epilogue_grads(x.data_ptr(), w.data_ptr(), g.data_ptr(),
                                dx.data_ptr(), dw.data_ptr(),
                                partial.data_ptr(), dvec.data_ptr(), m, k, n,
                                _op_info(ops), len(ops),
                                _DTYPE_CODE[x.dtype],
                                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, fn)
    support.count_launch(fn)
    return dx, dw, dvec


def fused_epilogue_bwd(x: torch.Tensor, w: torch.Tensor,
                       ops: Sequence[torch.Tensor], stages,
                       dy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  List[torch.Tensor]]:
    """The gradients of :func:`fused_epilogue_fwd` at ``dy``: ``(dx, dw,
    dops)`` in the dtypes of x, w and each operand (two launches)."""
    g, partial, dres = fused_epilogue_bwd_rows(x, w, ops, stages, dy)
    dx, dw, dvec = fused_epilogue_bwd_grads(x, w, ops, g, partial)
    dops = [d if d is not None else dvec[i:i + 1].to(o.dtype)
            for i, (d, o) in enumerate(zip(dres, ops))]
    return dx, dw.to(w.dtype), dops
