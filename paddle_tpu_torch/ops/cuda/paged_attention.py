"""Paged decode attention on Hopper: the wrapper of
``csrc/paged_attention.cu``.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/paged_attention.py``
(``_decode_kernel``, entry ``paged_attention_decode``): one query token
per sequence slot attends over a page-table-indexed K/V pool, with an
online softmax in f32, positions ``>= lengths[s]`` masked, and each KV
head serving ``H / Hkv`` query heads (GQA).  The TPU kernel's grid
(slot, page) carried its (m, l, acc) state in VMEM from one page step
to the next; here a slot's live pages are split over up to C thread
blocks (C from :func:`clusters_for`: as many as keep the grid resident,
fixed per (S, H, Hkv, D, dtype) and card), launched as a thread-block
cluster of :func:`cluster_blocks` of them per (slot, KV head).  Each
block reads ``page_table[s, p]`` and ``lengths[s]`` on the card and
keeps its state in registers, and the cluster's first block merges the
partial states over distributed shared memory in a fixed order (no
atomics: two runs agree bit for bit).  A slot's result depends on its
own length and C only, not on the other slots or the table width.
Each warp keeps its next step's K and V rows in flight while it
consumes this step's.

**Bound:** HBM bytes.  Each slot reads ``len x Hkv x D x 2 x
sizeof(dtype)`` bytes of K/V per layer and does 4 flops per element
read; the kernel touches only live pages (``ceil(len / page)``, not the
table width ``P``) and reads each K/V row once for all the query heads
of its group.  The source file says more.

**Length 0:** a slot with ``lengths[s] == 0`` gets zeros, as from the
TPU kernel.  The plain version (:func:`paged_attention_reference` in
``ops/attention.py``) follows the JAX reference instead and returns the
mean of V over the table's positions there, because its softmax over
an all-masked row is uniform.  The generation engine always passes
``lengths = positions + 1 >= 1``.

**Numerics:** f32 or bf16 inputs, f32 accumulation; ``q * scale`` and
the probabilities stay f32 (the TPU kernel rounds both to the pool's
type before its MXU dots).  The output has ``q``'s dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from . import support

__all__ = ["paged_attention_decode", "cluster_size", "clusters_for",
           "cluster_blocks", "SUPPORTED_HEAD_DIMS", "SUPPORTED_GROUPS",
           "MAX_CLUSTER", "MIN_TOKENS"]

KERNEL = "paged_attention"
# the (head_dim, H / Hkv) instances csrc/paged_attention.cu compiles
SUPPORTED_HEAD_DIMS = (64, 128, 256)
SUPPORTED_GROUPS = (1, 2, 4, 8)
MAX_CLUSTER = 8           # the portable thread-block cluster size
MIN_TOKENS = 32           # a block's share holds at least these (kMinTokens)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def cluster_size(work_blocks: int, resident: Sequence[int]) -> int:
    """The blocks C a slot may be split over, 1 to :data:`MAX_CLUSTER`:
    the most that keep the whole grid (S x Hkv = ``work_blocks``
    clusters of C) resident on the card at once, where ``resident[c -
    1]`` is how many clusters of c blocks the card holds at once; 1
    where none does.  Each block takes ``ceil(live pages / C)`` pages of
    its slot (at least :data:`MIN_TOKENS` tokens' worth), so the longest
    slot is walked by up to C blocks at once."""
    for c in range(MAX_CLUSTER, 1, -1):
        if resident[c - 1] >= work_blocks:
            return c
    return 1


def cluster_blocks(clusters: int, table_pages: int, page: int) -> int:
    """The blocks the kernel launches as one cluster for a slot split
    over ``clusters``: no more than a slot of ``table_pages`` pages can
    have shares of :data:`MIN_TOKENS` tokens (``cluster_blocks`` in
    ``csrc/paged_attention.cu``), so a narrow table launches no idle
    blocks; the split, and so the result, does not depend on it."""
    min_pages = -(-MIN_TOKENS // max(page, 1))
    return max(1, min(clusters, -(-table_pages // min_pages)))


_clusters: Dict[tuple, int] = {}


def clusters_for(q: torch.Tensor, k_pool: torch.Tensor) -> int:
    """The blocks C :func:`paged_attention_decode` may split a slot over
    for q [S, H, D] and a pool [..., page, Hkv, D] on the card: from the
    occupancy calculator's clusters of each size on q's card, worked out
    once per (card, dtype, S, H, Hkv, D) and cached (host queries, no
    sync)."""
    S, H, D = q.shape
    hkv = k_pool.shape[-2]
    key = (q.get_device(), q.dtype, S, H, hkv, D)
    c = _clusters.get(key)
    if c is None:
        lib = support.load_library()
        with torch.cuda.device(q.device):
            resident = [lib.ptt_paged_decode_max_clusters(
                D, H // hkv, _DTYPE_CODE[q.dtype], n)
                for n in range(1, MAX_CLUSTER + 1)]
        if resident[0] <= 0 or min(resident) < 0:
            raise RuntimeError(f"paged_attention_decode: no occupancy for "
                               f"D={D} G={H // hkv} {q.dtype} "
                               f"(codes {resident})")
        c = _clusters[key] = cluster_size(S * hkv, resident)
    return c


def _check(q, k_pool, v_pool, page_table, lengths, layer):
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_table": page_table, "lengths": lengths}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_attention_decode: {name} is on "
                             f"{t.device}, expected the CUDA device "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_decode: {name} must be "
                             "contiguous")
    if not support.dtype_ok(q.dtype):
        raise ValueError(f"paged_attention_decode: dtype {q.dtype} "
                         "(f32 or bf16 only)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("paged_attention_decode: q and the pools must "
                         "share one dtype")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention_decode: page_table and lengths "
                         "must be int32")
    if q.dim() != 3:
        raise ValueError("paged_attention_decode: q must be [S, H, D]")
    if k_pool.shape != v_pool.shape:
        raise ValueError("paged_attention_decode: k_pool and v_pool "
                         "shapes differ")
    want = 4 if layer is None else 5
    if k_pool.dim() != want:
        raise ValueError(f"paged_attention_decode: a {want}-D pool is "
                         f"needed with layer={layer}")
    S, H, D = q.shape
    hkv = k_pool.shape[-2]
    if k_pool.shape[-1] != D:
        raise ValueError("paged_attention_decode: head dims differ")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention_decode: head_dim {D} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if H % hkv or H // hkv not in SUPPORTED_GROUPS:
        raise ValueError(f"paged_attention_decode: H/Hkv = {H}/{hkv} "
                         f"must be one of {SUPPORTED_GROUPS}")
    if page_table.dim() != 2 or page_table.shape[0] != S \
            or tuple(lengths.shape) != (S,):
        raise ValueError("paged_attention_decode: page_table must be "
                         "[S, P] and lengths [S]")
    if not 1 <= S <= 65535 or hkv > 65535:
        raise ValueError("paged_attention_decode: S and Hkv must lie in "
                         "[1, 65535]")
    if layer is not None and not 0 <= int(layer) < k_pool.shape[0]:
        raise ValueError(f"paged_attention_decode: layer {layer} out of "
                         f"range for {k_pool.shape[0]} layers")
    align = (D // 32) * q.element_size()       # one lane's vector load
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % align:
            raise ValueError(f"paged_attention_decode: {name} must be "
                             f"{align}-byte aligned")


def paged_attention_decode(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor,
                           scale: Optional[float] = None,
                           layer: Optional[int] = None) -> torch.Tensor:
    """Gather-free decode attention on the card; the same array contract
    as ``ops.attention.paged_attention_reference``: q [S, H, D], pools
    [N, page, Hkv, D] — or [L, N, page, Hkv, D] with ``layer`` —
    page_table [S, P] int32, lengths [S] int32 -> out [S, H, D].  The
    blocks a slot is split over are :func:`clusters_for` q and the pool.

    Every tensor must be a contiguous CUDA tensor; anything the kernel
    does not take raises ``ValueError``.  Page ids must lie in [0, N):
    a slot whose live pages name another id gets NaN."""
    _check(q, k_pool, v_pool, page_table, lengths, layer)
    clusters = clusters_for(q, k_pool)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    S, H, D = q.shape
    N, page, hkv = k_pool.shape[-4], k_pool.shape[-3], k_pool.shape[-2]
    offset = 0
    if layer is not None:
        offset = int(layer) * N * page * hkv * D * k_pool.element_size()
    lib = support.load_library()
    out = torch.empty_like(q)
    # the raw handle, without a Stream object: the decode step is
    # host-bound and calls this 24 times
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    rc = lib.ptt_paged_decode(
        q.data_ptr(), k_pool.data_ptr() + offset,
        v_pool.data_ptr() + offset, page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), S, H, hkv, D,
        page_table.shape[1], page, N, float(scale), int(clusters),
        _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_decode: launch failed "
                           f"(code {rc})")
    support.count_launch(KERNEL)
    return out
