"""Paged KV cache: a preallocated page pool + per-sequence page tables.

The cache is one preallocated pool of fixed-size pages

    k_pool/v_pool: [num_layers, 1 + num_pages, page_size, heads, dim]

and every sequence owns an int32 *page table* mapping its logical pages
to physical pool pages.  Growing a sequence means appending a page
index to its table; the pool's shape never changes.

Physical page 0 is the **scratch page**: it is never allocated, and
idle decode slots point their whole table at it, so the scatter of new
K/V (which always writes every slot's row) lands harmlessly there
instead of corrupting a live sequence's pages.

The pools are updated **in place**: :func:`write_token` and
:func:`write_prompt` scatter with ``index_put_`` into the tensors they
are given and return the same tensors.  (The JAX package threads the
pools functionally through its compiled steps and gets the in-place
update from buffer donation instead.)

Allocation is host-side and O(1) amortized (a LIFO free list).  The
generation engine reserves a sequence's worst-case page count at
admission, so the pool cannot run out mid-flight.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..core.dtype import dtype_name
from ..core.placement import device as _resolve_device

__all__ = ["PagePool", "KVCacheConfig", "write_token", "write_prompt",
           "pages_needed"]


class KVCacheConfig:
    """Static geometry of a paged KV cache."""

    __slots__ = ("num_layers", "num_kv_heads", "head_dim", "page_size",
                 "num_pages", "max_context", "dtype")

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 page_size: int = 16, num_pages: int = 256,
                 max_context: int = 512, dtype=torch.float32):
        if page_size < 1 or num_pages < 1:
            raise ValueError("page_size and num_pages must be >= 1")
        if max_context < 1:
            raise ValueError("max_context must be >= 1")
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_context = int(max_context)
        self.dtype = dtype

    @property
    def pages_per_seq(self) -> int:
        """Page-table width: logical pages covering ``max_context``."""
        return -(-self.max_context // self.page_size)

    def pages_for(self, tokens: int) -> int:
        """Physical pages a sequence of ``tokens`` total tokens needs."""
        return max(1, -(-int(tokens) // self.page_size))

    def to_dict(self) -> dict:
        return {s: (dtype_name(self.dtype) if s == "dtype"
                    else getattr(self, s)) for s in self.__slots__}


class PagePool:
    """K/V page pool on ``device`` + host-side free-list allocator.

    ``kv = (k_pool, v_pool)`` is updated in place by the model's
    prefill/decode; the pool object hands out and reclaims page indices
    and tracks accounting.  ``device=None`` places the pool on the
    current CUDA device (raising when there is none)."""

    def __init__(self, config: KVCacheConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.device = _resolve_device(device)
        c = config
        # +1: physical page 0 is the never-allocated scratch page
        self._shape = (c.num_layers, 1 + c.num_pages, c.page_size,
                       c.num_kv_heads, c.head_dim)
        # LIFO free list: hottest (most recently freed) pages reused
        # first, which keeps the working set of a churning slot compact
        self._free: List[int] = list(range(c.num_pages, 0, -1))
        self._in_use = 0
        self.kv: Tuple[torch.Tensor, torch.Tensor] = self.reset_kv()

    def reset_kv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero the pools (allocating them on first use)."""
        kv = getattr(self, "kv", None)
        if kv is None:
            self.kv = tuple(torch.zeros(self._shape, dtype=self.config.dtype,
                                        device=self.device)
                            for _ in range(2))
        else:
            for t in kv:
                t.zero_()
        return self.kv

    # -- accounting --------------------------------------------------------
    @property
    def num_pages(self) -> int:
        return self.config.num_pages

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self._in_use

    def utilization(self) -> float:
        return self._in_use / self.config.num_pages

    # -- allocation --------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages, or None (and take nothing) if short — an
        all-or-nothing grant so admission can never half-reserve."""
        n = int(n)
        if n < 0:
            raise ValueError("alloc(n) needs n >= 0")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._in_use += n
        return pages

    def free(self, pages: Sequence[int]) -> None:
        pages = [int(p) for p in pages]
        for p in pages:
            if p < 1 or p > self.config.num_pages:
                raise ValueError(f"page {p} is not an allocatable index")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.extend(pages)
        self._in_use -= len(pages)
        if self._in_use < 0:
            raise RuntimeError("page accounting went negative")


def write_token(pool: torch.Tensor, layer: int, vals: torch.Tensor,
                page_table: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
    """Scatter one new K (or V) row per sequence into its page, in place.

    pool: [L, N, page, H, D]; layer: int; vals: [S, H, D]; page_table:
    [S, P] int32; positions: [S] int32 (0-based logical position being
    written).  Idle slots' tables point at scratch page 0, so the
    unconditional scatter stays safe.  Returns ``pool``."""
    page = pool.shape[2]
    pos = positions.long()
    pid = page_table.long().gather(1, (pos // page)[:, None])[:, 0]
    pool[layer].index_put_((pid, pos % page), vals.to(pool.dtype))
    return pool


def write_prompt(pool: torch.Tensor, layer: int, vals: torch.Tensor,
                 page_table: torch.Tensor, length: int) -> torch.Tensor:
    """Scatter a whole prompt's K (or V) rows for ONE sequence, in place.

    pool: [L, N, page, H, D]; layer: int; vals: [T, H, D] (rows past
    ``length`` are padding); page_table: [P] int32; length: int.
    Padding rows are redirected to scratch page 0.  Returns ``pool``."""
    T = vals.shape[0]
    page = pool.shape[2]
    pos = torch.arange(T, device=pool.device)
    pid = page_table.long()[pos // page]
    pid = torch.where(pos < int(length), pid, torch.zeros_like(pid))
    pool[layer].index_put_((pid, pos % page), vals.to(pool.dtype))
    return pool


def pages_needed(prompt_len: int, max_new_tokens: int,
                 page_size: int) -> int:
    """Worst-case pages a request can touch (admission reservation)."""
    total = int(prompt_len) + int(max_new_tokens)
    return max(1, math.ceil(total / int(page_size)))
