"""MultiHeadAttention, TransformerEncoderLayer and TransformerEncoder
(paddle_tpu.nn.layer.transformer).

Attention goes through ``F.scaled_dot_product_attention``, which sends
every shape the flash gate takes to the flash-attention kernels on the
card.

``cache`` is paddle_tpu's: a ``MultiHeadAttention.Cache(k, v)`` (from
``gen_cache(key)``, empty) grows by this call's keys and values and
comes back as the last output (incremental decoding); a
``StaticCache(k, v)`` (``gen_cache(key, value, type=StaticCache)``)
holds projected keys and values used as they are (cross attention).
The decoder family is not ported yet."""
from __future__ import annotations

import collections
import copy

import torch

from ...core.tensor import wrap
from ...ops.manipulation import concat
from .. import functional as F
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=device)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _heads(self, proj, x):
        return proj(x).reshape(x.shape[0], -1, self.num_heads,
                               self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key``/``value`` projected (``type=
        StaticCache``), else an empty ``Cache`` ``[B, 0, H, Dh]``."""
        if type == MultiHeadAttention.StaticCache:
            return self.StaticCache(
                self._heads(self.k_proj, key),
                self._heads(self.v_proj, key if value is None else value))
        empty = wrap(torch.zeros((key.shape[0], 0, self.num_heads,
                                  self.head_dim), device=key.device))
        return self.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._heads(self.q_proj, query)
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj, key)
            v = self._heads(self.v_proj, value)
        if isinstance(cache, self.Cache):
            k = concat([cache.k, k], axis=1)
            v = concat([cache.v, v], axis=1)
            cache = self.Cache(k, v)
        if self.need_weights:
            out, weights = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training, return_weights=True)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training)
        out = self.out_proj(out.reshape(query.shape[0], -1, self.embed_dim))
        outs = [out] + ([weights] if self.need_weights else []) + (
            [cache] if cache is not None else [])
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=device)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (deep copies, so all
    start from its weights, as in paddle_tpu)."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]
