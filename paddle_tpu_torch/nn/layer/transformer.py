"""MultiHeadAttention, the encoder and decoder layers and stacks, and
``Transformer`` (paddle_tpu.nn.layer.transformer), with paddle_tpu's
parameter names.

Attention goes through ``F.scaled_dot_product_attention``, which sends
every shape the flash gate takes to the flash-attention kernels on the
card.

``cache`` is paddle_tpu's: a ``MultiHeadAttention.Cache(k, v)`` (from
``gen_cache(key)``, empty) grows by this call's keys and values and
comes back as the last output (incremental decoding); a
``StaticCache(k, v)`` (``gen_cache(key, value, type=StaticCache)``)
holds projected keys and values used as they are (cross attention).
A decoder layer's cache is the pair ``(Cache, StaticCache)`` of its
self- and cross-attention (``TransformerDecoderLayer.gen_cache``).

Only an attention without a mask reaches the flash kernels: in training
the decoder's masked self-attention takes the unfused path, as in
paddle_tpu, while the encoder's self-attention, the cross-attention and
every attention of an incremental decode (one query against the cache,
no mask) take the kernels."""
from __future__ import annotations

import collections
import copy

import torch

from ...core.placement import device as _resolve_device
from ...core.tensor import wrap
from ...ops.manipulation import concat
from .. import functional as F
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


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


class TransformerDecoderLayer(Layer):
    """Masked self-attention, cross-attention over ``memory`` and the
    feed-forward block, each with a residual and a LayerNorm before
    (``normalize_before``) or after it."""

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
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def _block(self, x, norm, drop, fn):
        """``x + drop(fn(x'))`` with ``x'`` normed before or the sum
        after, as ``normalize_before`` says; ``fn`` may return a pair
        (output, cache), whose cache is passed through."""
        y = fn(norm(x) if self.normalize_before else x)
        y, extra = y if isinstance(y, tuple) else (y, None)
        x = x + drop(y)
        return (x if self.normalize_before else norm(x)), extra

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        c = (None, None) if cache is None else cache
        tgt, inc = self._block(tgt, self.norm1, self.dropout1, lambda x: (
            self.self_attn(x, x, x, tgt_mask) if cache is None
            else self.self_attn(x, x, x, tgt_mask, c[0])))
        tgt, static = self._block(tgt, self.norm2, self.dropout2, lambda x: (
            self.cross_attn(x, memory, memory, memory_mask) if cache is None
            else self.cross_attn(x, memory, memory, memory_mask, c[1])))
        tgt, _ = self._block(tgt, self.norm3, self.dropout3, lambda x: (
            self.linear2(self.dropout(self.activation(self.linear1(x))))))
        return tgt if cache is None else (tgt, (inc, static))

    def gen_cache(self, memory):
        """``(Cache, StaticCache)``: an empty self-attention cache and
        the cross-attention's keys and values of ``memory``."""
        return (self.self_attn.gen_cache(memory,
                                         type=MultiHeadAttention.Cache),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    """``num_layers`` deep copies of ``decoder_layer``, then ``norm``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One ``(Cache, StaticCache)`` a layer; ``do_zip`` regroups them
        as ``[(Cache, ...), (StaticCache, ...)]``."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    """The encoder-decoder of Vaswani et al. (2017); the defaults are
    their "base" model.  ``custom_encoder`` / ``custom_decoder`` replace
    the stacks; with ``normalize_before`` each stack ends in a
    LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = (LayerNorm(d_model, device=device) if normalize_before
                    else None)
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args), num_encoder_layers, norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = (LayerNorm(d_model, device=device) if normalize_before
                    else None)
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args), num_decoder_layers, norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` float mask: 0 on and below the diagonal,
        -inf above it (added to the attention scores)."""
        visible = torch.ones((length, length), dtype=torch.bool,
                             device=_resolve_device(device)).tril()
        return wrap(torch.zeros(visible.shape, device=visible.device)
                    .masked_fill(~visible, float("-inf")))
