"""Fused Adam on Hopper: the wrapper of ``csrc/fused_adam.cu``.

Replaces the TPU kernel of ``paddle_tpu/ops/pallas/fused_adam.py``:
``fused_adam_update`` (body ``_adam_kernel``).  One kernel, one launch
count, ``fused_adam``: :class:`AdamTable` holds the device table of
``(p, g, m, v)`` rows for a fixed list of tensors (built once, by the
static Executor once per compiled step), and :func:`fused_adam` updates
every tensor of it in place in one launch, reading ``lr`` and ``step``
from device scalars and, when given, the anomaly sentry's ``skip`` flag
(a device int32 scalar: not 0 makes every block return before it
writes, so a flagged step leaves every p, m and v bitwise as it was).

Every tensor must be a contiguous f32 CUDA tensor on one device, each
quartet of one shape; anything else raises ``ValueError``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import support

__all__ = ["AdamTable", "fused_adam", "KERNELS"]

KERNELS = ("fused_adam",)


class AdamTable:
    """The device table of one list of ``(p, g, m, v)`` quartets; keeps
    the tensors alive while the table points at them."""

    def __init__(self, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor]):
        if not (len(params) == len(grads) == len(ms) == len(vs)) \
                or not params:
            raise ValueError("fused_adam: needs equally long, non-empty "
                             "lists of p, g, m and v")
        dev = params[0].device
        for quartet in zip(params, grads, ms, vs):
            for t in quartet:
                if t.device.type != "cuda" or t.device != dev:
                    raise ValueError(f"fused_adam: a tensor is on "
                                     f"{t.device}, expected the CUDA device "
                                     f"{dev}")
                if t.dtype != torch.float32 or not t.is_contiguous():
                    raise ValueError("fused_adam: every tensor must be "
                                     "contiguous f32")
                if t.shape != quartet[0].shape:
                    raise ValueError("fused_adam: p, g, m and v of one "
                                     "parameter must share its shape")
        self.device = dev
        self.tensors = [list(q) for q in zip(params, grads, ms, vs)]
        chunk = support.load_library().ptt_adam_chunk()
        rows, blk_entry, blk_start = [], [], []
        for i, q in enumerate(self.tensors):
            n = q[0].numel()
            ptrs = [t.data_ptr() for t in q]
            rows.append(ptrs + [n, int(all(p % 16 == 0 for p in ptrs))])
            for s in range(0, n, chunk):
                blk_entry.append(i)
                blk_start.append(s)
        # pointers above 2^63 do not occur on this card's address space
        self.table = torch.tensor(rows, dtype=torch.int64, device=dev)
        self.blk_entry = torch.tensor(blk_entry, dtype=torch.int32,
                                      device=dev)
        self.blk_start = torch.tensor(blk_start, dtype=torch.int64,
                                      device=dev)
        self.n_blocks = len(blk_entry)
        self.numel = sum(q[0].numel() for q in self.tensors)


def fused_adam(table: AdamTable, lr: torch.Tensor, step: torch.Tensor, *,
               beta1: float = 0.9, beta2: float = 0.999,
               eps: float = 1e-8, skip: Optional[torch.Tensor] = None
               ) -> None:
    """One Adam step over every quartet of ``table``, in place; ``lr``
    and ``step`` are f32 scalars on the table's device, ``skip`` (None,
    or an int32 scalar there) the sentry's flag: not 0 = write
    nothing."""
    fn = KERNELS[0]
    for name, t in (("lr", lr), ("step", step)):
        if (t.device != table.device or t.dtype != torch.float32
                or t.numel() != 1):
            raise ValueError(f"{fn}: {name} must be an f32 scalar on "
                             f"{table.device}")
    if skip is not None and (skip.device != table.device
                             or skip.dtype != torch.int32
                             or skip.numel() != 1):
        raise ValueError(f"{fn}: skip must be an int32 scalar on "
                         f"{table.device}")
    lib = support.load_library()
    rc = lib.ptt_fused_adam(
        table.table.data_ptr(), table.blk_entry.data_ptr(),
        table.blk_start.data_ptr(), table.n_blocks, lr.data_ptr(),
        step.data_ptr(), None if skip is None else skip.data_ptr(),
        float(beta1), float(beta2), float(1.0 - beta1),
        float(1.0 - beta2), math.log(beta1), math.log(beta2), float(eps),
        torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: launch failed (code {rc})")
    support.count_launch(fn)
