"""The bench's BERT masked-LM, ported (``bench.build_model``).

:func:`build_model` builds the encoder LM ``bench_bert`` trains: token
and position embeddings, a post-norm ``TransformerEncoder`` with GELU,
a final LayerNorm, and a vocab ``head`` that only the loss reads
(:func:`mlm_loss`: ``F.linear_cross_entropy``, so the ``[tokens,
vocab]`` logits never exist whole).  Parameter names are paddle_tpu's.

:func:`build_bert_static` records ``bench.build_bert_static``'s static
training program: the same layers in the same order, so parameter order
matches paddle_tpu's.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import nn as pnn
from ..core.placement import device as _resolve_device
from ..nn import functional as F

__all__ = ["BertMLM", "build_model", "mlm_loss", "bench_flops_per_step",
           "palm_flops_per_step", "build_bert_static"]


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


def palm_flops_per_step(n_dense, layers, seq, batch, hidden) -> int:
    """Model FLOPs of one training step: 6 N T for the ``n_dense``
    parameters that multiply activations, plus 12 L B S^2 H for
    attention (PaLM appendix B)."""
    return (6 * n_dense * batch * seq
            + 12 * layers * batch * seq ** 2 * hidden)


def bench_flops_per_step(model: BertMLM, vocab, hidden, layers, seq,
                         batch) -> int:
    """``bench_bert``'s model FLOPs per step: the PaLM count without the
    two embedding tables."""
    n_params = sum(p.numel() for p in model.parameters())
    return palm_flops_per_step(n_params - (vocab * hidden + seq * hidden),
                               layers, seq, batch, hidden)


def build_bert_static(vocab, hidden, layers, heads, ffn, seq, batch,
                      device=None, seed=2024):
    """``bench.build_bert_static``: a BERT-shaped post-norm encoder
    masked-LM (no dropout) recorded as a static training program with
    ``Adam(1e-4).minimize(loss)``; parameters on ``device`` (``None``:
    ``get_device()``).  As in paddle_tpu, the position embedding is
    looked up eagerly while recording, so it is a constant of the
    program and not trained.  Returns ``(program, loss, feeds)``;
    ``feeds(rng)`` draws int64 ``ids`` and ``labels`` from a numpy
    ``RandomState``."""
    from .. import optimizer, static
    from ..core import rng
    from ..ops.creation import arange

    dev = _resolve_device(device)
    rng.seed(seed)
    main = static.Program()
    with static.program_guard(main):
        ids = static.data("ids", [batch, seq], "int64")
        labels = static.data("labels", [batch, seq], "int64")
        tok = pnn.Embedding(vocab, hidden, device=dev)
        pos = pnn.Embedding(seq, hidden, device=dev)
        x = tok(ids) + pos(arange(seq, device=dev).unsqueeze(0))
        hd = hidden // heads
        for _ in range(layers):
            wq, wk, wv, proj = (pnn.Linear(hidden, hidden, device=dev)
                                for _ in range(4))
            ln1 = pnn.LayerNorm(hidden, device=dev)
            fc1 = pnn.Linear(hidden, ffn, device=dev)
            fc2 = pnn.Linear(ffn, hidden, device=dev)
            ln2 = pnn.LayerNorm(hidden, device=dev)
            q = wq(x).reshape([batch, seq, heads, hd])
            k = wk(x).reshape([batch, seq, heads, hd])
            v = wv(x).reshape([batch, seq, heads, hd])
            a = F.scaled_dot_product_attention(q, k, v)
            x = ln1(proj(a.reshape([batch, seq, hidden])) + x)
            h = F.gelu(fc1(x), approximate=True)
            x = ln2(fc2(h) + x)
        head = pnn.Linear(hidden, vocab, device=dev)
        logits = head(x)
        loss = F.cross_entropy(logits.reshape([-1, vocab]),
                               labels.reshape([-1]))
        optimizer.Adam(learning_rate=1e-4).minimize(loss)

    def feeds(r: np.random.RandomState):
        return {"ids": r.randint(0, vocab, (batch, seq), dtype=np.int64),
                "labels": r.randint(0, vocab, (batch, seq), dtype=np.int64)}

    return main, loss, feeds
