"""Reference generative model for the paged decode contract.

:class:`PagedDecoderLM` is a minimal transformer decoder that implements
the two-method contract :class:`~.generation.GenerationEngine` drives:

- ``prefill(tokens, length, kv, page_table)`` — dense causal attention
  over one (padded) prompt, writing every position's K/V into the
  sequence's pages, returning the logits at the last valid position;
- ``decode(tokens, positions, kv, page_tables)`` — one token per slot,
  K/V scattered into pages, attention through
  :func:`~paddle_tpu_torch.ops.attention.paged_attention_select` (the
  CUDA paged-decode kernel on the card where its gate takes the shapes,
  else the plain version).

Both take an optional ``params`` dict (name -> tensor) that replaces
the module's own parameters for the call: the engine passes its serving
weights that way, so a hot swap replaces one dict between steps.  The
parameter names are those of ``paddle_tpu.serving.PagedDecoderLM``
(``embed``, ``wq{l}``, ``wk{l}``, ``wv{l}``, ``wo{l}``, ``w1{l}``,
``w2{l}``); :func:`params_from_paddle_tpu` carries that model's weights
across.  ``dyadic=True`` rounds every weight to k/64 as the JAX model
does.

``init_cell_state`` and ``make_cell`` are the dense padded-cache
baseline: a ``BeamSearchDecoder`` cell over fixed ``[N, L, t_max, Hkv,
D]`` K/V buffers for ``nn.dynamic_decode``, one request at a time
(``bench_generation``'s baseline against the paged engine).  Its
attention is plain PyTorch over all ``t_max`` rows, as the JAX model's.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.placement import device as _resolve_device
from ..ops import attention as _attn
from .kv_cache import write_prompt, write_token

__all__ = ["PagedDecoderLM", "params_from_paddle_tpu"]

_NEG = -1e30
KV = Tuple[torch.Tensor, torch.Tensor]


def _plain(t) -> torch.Tensor:
    """A state leaf or token tensor as a plain torch tensor (a paddle
    Tensor's methods shadow torch's)."""
    if isinstance(t, torch.Tensor):
        return torch.Tensor.as_subclass(t, torch.Tensor)
    return torch.as_tensor(np.asarray(t))


def params_from_paddle_tpu(np_params: Mapping[str, np.ndarray],
                           device: Union[str, torch.device, None] = None
                           ) -> Dict[str, torch.Tensor]:
    """The parameters of a ``paddle_tpu`` ``PagedDecoderLM``, taken as
    numpy arrays (``{k: np.asarray(v) for k, v in lm.params.items()}``),
    as tensors on ``device`` — ready for
    ``PagedDecoderLM.load_state_dict``."""
    dev = _resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in np_params.items()}


class PagedDecoderLM(nn.Module):
    """Pre-norm-free residual transformer LM.

    Geometry attributes (``num_layers`` / ``num_kv_heads`` /
    ``head_dim`` / ``vocab_size``) are the engine's KV-cache contract.
    Weights are drawn from a ``torch.Generator`` seeded with ``seed`` on
    the model's device, which ``device=None`` puts on the current CUDA
    device (raising when there is none).
    """

    def __init__(self, vocab_size: int = 64, hidden: int = 32,
                 num_layers: int = 2, num_heads: int = 4,
                 num_kv_heads: int = 0, ffn: int = 0, seed: int = 0,
                 dyadic: bool = False,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        if hidden % num_heads:
            raise ValueError("hidden must divide by num_heads")
        self.vocab_size = int(vocab_size)
        self.hidden = int(hidden)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads) or int(num_heads)
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must divide by num_kv_heads")
        self.head_dim = self.hidden // self.num_heads
        self.ffn = int(ffn) or 2 * self.hidden
        dev = _resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        E, F, V = self.hidden, self.ffn, self.vocab_size
        kvd = self.num_kv_heads * self.head_dim

        def w(name, shape, fan_in):
            a = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) / math.sqrt(fan_in)
            if dyadic:
                a = torch.round(a * 64.0) / 64.0
            self.register_parameter(name,
                                    nn.Parameter(a, requires_grad=False))

        w("embed", (V, E), E)
        for l in range(self.num_layers):
            w(f"wq{l}", (E, E), E)
            w(f"wk{l}", (E, kvd), E)
            w(f"wv{l}", (E, kvd), E)
            w(f"wo{l}", (E, E), E)
            w(f"w1{l}", (E, F), E)
            w(f"w2{l}", (F, E), F)
        self._scale = 1.0 / math.sqrt(self.head_dim)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The module's own weights as a name -> tensor dict."""
        return dict(self.named_parameters())

    # -- shared pieces -----------------------------------------------------
    def _qkv(self, p, x, l):
        """x: [..., E] -> q [..., H, D], k/v [..., Hkv, D]."""
        lead = tuple(x.shape[:-1])
        q = (x @ p[f"wq{l}"]).reshape(lead + (self.num_heads,
                                              self.head_dim))
        k = (x @ p[f"wk{l}"]).reshape(lead + (self.num_kv_heads,
                                              self.head_dim))
        v = (x @ p[f"wv{l}"]).reshape(lead + (self.num_kv_heads,
                                              self.head_dim))
        return q, k, v

    def _mlp_residual(self, p, x, attn_out, l):
        x = x + attn_out.reshape(x.shape) @ p[f"wo{l}"]
        return x + torch.relu(x @ p[f"w1{l}"]) @ p[f"w2{l}"]

    def _group(self, kv):
        """Broadcast KV heads over query-head groups (GQA)."""
        if self.num_kv_heads == self.num_heads:
            return kv
        return kv.repeat_interleave(self.num_heads // self.num_kv_heads,
                                    dim=-2)

    # -- paged contract (GenerationEngine) ---------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, length: int, kv: KV,
                page_table: torch.Tensor,
                params: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, KV]:
        """tokens: [T] int (padded prompt); length: int; kv: (k_pool,
        v_pool) [L, N, page, Hkv, D], updated in place; page_table: [P]
        int32.  Returns (logits [V] at position length-1, kv)."""
        p = self.params if params is None else params
        k_pool, v_pool = kv
        T = tokens.shape[0]
        x = p["embed"][tokens.long()]                       # [T, E]
        pos = torch.arange(T, device=x.device)
        # causal AND length-bounded: key j visible to query i iff
        # j <= i and j < length
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < int(length))
        for l in range(self.num_layers):
            q, k, v = self._qkv(p, x, l)                    # [T, H/Hkv, D]
            write_prompt(k_pool, l, k, page_table, length)
            write_prompt(v_pool, l, v, page_table, length)
            kk, vv = self._group(k), self._group(v)         # [T, H, D]
            s = torch.einsum("ihd,jhd->hij", q.float(),
                             kk.float()) * self._scale
            s = torch.where(mask[None], s, torch.full_like(s, _NEG))
            w = torch.softmax(s, dim=-1)
            attn = torch.einsum("hij,jhd->ihd", w,
                                vv.float()).to(x.dtype)
            x = self._mlp_residual(p, x, attn, l)
        last = x[int(length) - 1]                           # [E]
        return last @ p["embed"].T, (k_pool, v_pool)

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, positions: torch.Tensor, kv: KV,
               page_tables: torch.Tensor,
               params: Optional[Mapping[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, KV]:
        """tokens/positions: [S] int32; page_tables: [S, P] int32; kv
        updated in place.  Returns (logits [S, V], kv)."""
        p = self.params if params is None else params
        k_pool, v_pool = kv
        x = p["embed"][tokens.long()]                       # [S, E]
        lengths = positions + 1
        for l in range(self.num_layers):
            q, k, v = self._qkv(p, x, l)
            write_token(k_pool, l, k, page_tables, positions)
            write_token(v_pool, l, v, page_tables, positions)
            attn = _attn.paged_attention_select(
                q, k_pool, v_pool, page_tables, lengths,
                scale=self._scale, layer=l)
            x = self._mlp_residual(p, x, attn, l)
        return x @ p["embed"].T, (k_pool, v_pool)

    # -- BeamSearchDecoder cell contract (dynamic_decode baseline) ---------
    @torch.no_grad()
    def init_cell_state(self, prompt, t_max: int) -> Dict[str, torch.Tensor]:
        """Dense-cache prefill for the per-request baseline.

        Feeds ``prompt[:-1]`` through the network (the last prompt token
        becomes ``dynamic_decode``'s start token), caching K/V into
        fixed [1, L, t_max, Hkv, D] buffers on the model's device.
        Returns the cell-state dict (leading batch dim 1) for
        ``dynamic_decode(inits=...)``; set its ``"limit"`` to the
        request's token budget."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must carry at least one token")
        n_ctx = prompt.size - 1
        t_max = int(t_max)
        if n_ctx > t_max:
            raise ValueError(f"prompt needs {n_ctx} cache rows, "
                             f"t_max={t_max}")
        p = self.params
        dev = p["embed"].device
        L, Hkv, D = self.num_layers, self.num_kv_heads, self.head_dim
        k_cache = torch.zeros((1, L, t_max, Hkv, D), dtype=torch.float32,
                              device=dev)
        v_cache = torch.zeros_like(k_cache)
        if n_ctx:
            ids = torch.from_numpy(prompt[:-1].astype(np.int64)).to(dev)
            x = p["embed"][ids]                             # [n, E]
            pos = torch.arange(n_ctx, device=dev)
            mask = pos[None, :] <= pos[:, None]
            for l in range(self.num_layers):
                q, k, v = self._qkv(p, x, l)
                k_cache[0, l, :n_ctx] = k
                v_cache[0, l, :n_ctx] = v
                kk, vv = self._group(k), self._group(v)
                s = torch.einsum("ihd,jhd->hij", q.float(),
                                 kk.float()) * self._scale
                s = torch.where(mask[None], s, torch.full_like(s, _NEG))
                w = torch.softmax(s, dim=-1)
                attn = torch.einsum("hij,jhd->ihd", w,
                                    vv.float()).to(x.dtype)
                x = self._mlp_residual(p, x, attn, l)
        i32 = dict(dtype=torch.int32, device=dev)
        return {"k": k_cache, "v": v_cache,
                "pos": torch.full((1,), n_ctx, **i32),
                "gen": torch.zeros((1,), **i32),
                "limit": torch.zeros((1,), **i32)}

    def make_cell(self, eos_id: int):
        """A ``cell(tokens, states) -> (logits, states)`` closure over a
        dense padded KV cache — the BeamSearchDecoder contract.  When a
        row's ``gen`` count reaches its ``limit``, its logits collapse
        onto ``eos_id`` so dynamic_decode's early exit ends the row (one
        cell serves ragged per-request budgets).  The states it returns
        are new tensors; the ones it is given are not written."""
        p = self.params
        eos_row = torch.full((self.vocab_size,), _NEG, dtype=torch.float32,
                             device=p["embed"].device)
        eos_row[int(eos_id)] = 0.0

        @torch.no_grad()
        def cell(tok, states):
            x0 = _plain(tok).to(p["embed"].device).long()       # [N]
            st = {k: _plain(v) for k, v in states.items()}
            k_cache, v_cache = st["k"], st["v"]           # [N,L,T,Hkv,D]
            pos, gen, limit = st["pos"], st["gen"], st["limit"]
            T = k_cache.shape[2]
            x = p["embed"][x0]                                  # [N, E]
            t = torch.arange(T, device=x.device)[None, :]
            onehot = (t == pos[:, None])[:, :, None, None]      # [N,T,1,1]
            visible = t <= pos[:, None]                         # [N, T]
            ks, vs = [], []
            for l in range(self.num_layers):
                q, k, v = self._qkv(p, x, l)                # [N, Hkv, D]
                # this token's K/V written at pos: an O(T) masked
                # update, the dense baseline's raggedness tax
                kl = torch.where(onehot, k[:, None], k_cache[:, l])
                vl = torch.where(onehot, v[:, None], v_cache[:, l])
                ks.append(kl)
                vs.append(vl)
                kk, vv = self._group(kl), self._group(vl)   # [N, T, H, D]
                s = torch.einsum("nhd,nthd->nht", q.float(),
                                 kk.float()) * self._scale
                s = torch.where(visible[:, None, :], s,
                                torch.full_like(s, _NEG))
                w = torch.softmax(s, dim=-1)
                attn = torch.einsum("nht,nthd->nhd", w,
                                    vv.float()).to(x.dtype)
                x = self._mlp_residual(p, x, attn, l)
            logits = x @ p["embed"].T                           # [N, V]
            done = gen >= limit
            logits = torch.where(done[:, None], eos_row[None], logits)
            return logits, {"k": torch.stack(ks, 1),
                            "v": torch.stack(vs, 1), "pos": pos + 1,
                            "gen": gen + 1, "limit": limit}

        return cell
