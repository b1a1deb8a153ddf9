"""The bench's BERT masked-LM, ported (``bench.build_model``).

:func:`build_model` builds the encoder LM ``bench_bert`` trains: token
and position embeddings, a post-norm ``TransformerEncoder`` with GELU,
a final LayerNorm, and a vocab ``head`` that only the loss reads
(:func:`mlm_loss`: ``F.linear_cross_entropy``, so the ``[tokens,
vocab]`` logits never exist whole).  Parameter names are paddle_tpu's.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import nn as pnn
from ..core.placement import device as _resolve_device
from ..nn import functional as F

__all__ = ["BertMLM", "build_model", "mlm_loss", "bench_flops_per_step"]


class BertMLM(nn.Module):
    def __init__(self, vocab, hidden, layers, heads, ffn, seq, dropout,
                 device=None):
        super().__init__()
        dev = _resolve_device(device)
        self.hidden = hidden
        self.tok = pnn.Embedding(vocab, hidden, device=dev)
        self.pos = pnn.Embedding(seq, hidden, device=dev)
        enc = pnn.TransformerEncoderLayer(
            hidden, heads, ffn, dropout=dropout, activation="gelu",
            attn_dropout=dropout, act_dropout=dropout, device=dev)
        self.encoder = pnn.TransformerEncoder(enc, layers)
        self.norm = pnn.LayerNorm(hidden, device=dev)
        self.head = pnn.Linear(hidden, vocab, device=dev)

    def forward(self, ids):
        pos_ids = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = self.tok(ids) + self.pos(pos_ids)
        return self.norm(self.encoder(x))


def build_model(vocab, hidden, layers, heads, ffn, seq, dropout,
                device=None) -> BertMLM:
    """``bench.build_model`` with the same arguments, plus ``device``
    (the current CUDA device by default)."""
    return BertMLM(vocab, hidden, layers, heads, ffn, seq, dropout,
                   device=device)


def mlm_loss(model: BertMLM):
    """``loss_fn(out, labels)`` of ``bench_bert``: the fused, chunked
    head + cross entropy."""
    def loss_fn(out, labels):
        return F.linear_cross_entropy(out.reshape(-1, model.hidden),
                                      model.head.weight, model.head.bias,
                                      labels.reshape(-1))
    return loss_fn


def bench_flops_per_step(model: BertMLM, vocab, hidden, layers, seq,
                         batch) -> int:
    """``bench_bert``'s model FLOPs per step: 6 N T for the dense
    parameters plus 12 L B S^2 H for attention (PaLM appendix B)."""
    n_params = sum(p.numel() for p in model.parameters())
    n_dense = n_params - (vocab * hidden + seq * hidden)
    tokens = batch * seq
    return 6 * n_dense * tokens + 12 * layers * batch * seq ** 2 * hidden
