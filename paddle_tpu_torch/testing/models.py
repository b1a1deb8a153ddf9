"""The bench's BERT masked-LM, ported (``bench.build_model``).

:func:`build_model` builds the encoder LM ``bench_bert`` trains: token
and position embeddings, a post-norm ``TransformerEncoder`` with GELU,
a final LayerNorm, and a vocab ``head`` that only the loss reads
(:func:`mlm_loss`: ``F.linear_cross_entropy``, so the ``[tokens,
vocab]`` logits never exist whole).  Parameter names are paddle_tpu's.

:func:`build_bert_static` records ``bench.build_bert_static``'s static
training program: the same layers in the same order, so parameter order
matches paddle_tpu's.  :func:`build_gpt_static` is
``bench.build_gpt_static`` (``bench_pallas``'s GPT half), and
:func:`build_static_mlp` and :func:`build_static_lenet` are
``bench_static``'s two programs.

:func:`build_gpt` is ``bench.build_gpt``, the single-device causal
decoder ``bench_gpt`` trains (per-block recompute, tied embeddings),
with :data:`GPT_PRESETS` and :func:`gpt_pretrain_loss`.

:func:`build_gpt_pipeline` cuts the same decoder into the stages of
``parallel.pipeline``: the embedding, the blocks (one stage) and an
untied head, with :func:`gpt_pipeline_loss`.

:func:`build_gpt_hybrid` is ``bench.build_gpt``'s causal decoder made
tensor- and sequence-parallel (q, k, v and fc1 column-parallel, proj and
fc2 row-parallel, ring attention over 'sp'); :func:`gpt_loss` is
``bench_gpt``'s tied head through ``F.linear_cross_entropy``.

:class:`TransformerNMT` is the translation model of Vaswani et al.
(2017, sections 3.4-3.5) from the public ``paddle.nn`` API: one source
and target embedding scaled by sqrt(d_model), sinusoidal positions,
``nn.Transformer`` and an output projection tied to the embedding;
:func:`nmt_loss` is its label-smoothed cross entropy and
:func:`greedy_decode` decodes incrementally through the decoder's
caches, the encoder run once.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

import paddle_tpu_torch as paddle

from .. import nn as pnn
from ..core.placement import device as _resolve_device
from ..nn import functional as F
from ..nn.layer_base import ParamAttr

__all__ = ["BertMLM", "build_model", "mlm_loss", "bench_flops_per_step",
           "palm_flops_per_step", "build_bert_static", "build_gpt_static",
           "build_static_mlp", "build_static_lenet", "GPTHybrid",
           "build_gpt_hybrid", "gpt_loss", "gpt_flops_per_step", "GPT",
           "GPT_PRESETS", "build_gpt", "gpt_pretrain_loss", "GPTEmbed",
           "GPTHead", "build_gpt_pipeline", "gpt_pipeline_loss",
           "TransformerNMT", "nmt_loss", "greedy_decode",
           "nmt_flops_per_step", "sinusoid_positions"]


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


def build_gpt_static(vocab, hidden, layers, heads, ffn, seq, batch,
                     device=None, seed=2024, minimize=None):
    """``bench.build_gpt_static``: a GPT-shaped pre-norm causal decoder LM
    (no dropout, untied head) recorded as a static training program with
    ``Adam(1e-4).minimize(loss)`` (or ``minimize(loss)`` when given, e.g.
    through ``fleet.distributed_optimizer``); parameters on ``device``.  The
    residual adds after ``proj`` and ``fc2`` and the ``fc1`` + gelu FFN
    are the chains the fusion pass realizes.  The position embedding is
    a constant, as in :func:`build_bert_static`.  Returns ``(program,
    loss, feeds)``."""
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
            ln1 = pnn.LayerNorm(hidden, device=dev)
            wq, wk, wv, proj = (pnn.Linear(hidden, hidden, device=dev)
                                for _ in range(4))
            ln2 = pnn.LayerNorm(hidden, device=dev)
            fc1 = pnn.Linear(hidden, ffn, device=dev)
            fc2 = pnn.Linear(ffn, hidden, device=dev)
            h = ln1(x)
            q = wq(h).reshape([batch, seq, heads, hd])
            k = wk(h).reshape([batch, seq, heads, hd])
            v = wv(h).reshape([batch, seq, heads, hd])
            a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = proj(a.reshape([batch, seq, hidden])) + x
            h = ln2(x)
            x = fc2(F.gelu(fc1(h), approximate=True)) + x
        lnf = pnn.LayerNorm(hidden, device=dev)
        head = pnn.Linear(hidden, vocab, device=dev)
        logits = head(lnf(x))
        loss = F.cross_entropy(logits.reshape([-1, vocab]),
                               labels.reshape([-1]))
        if minimize is None:
            optimizer.Adam(learning_rate=1e-4).minimize(loss)
        else:
            minimize(loss)

    def feeds(r: np.random.RandomState):
        return {"ids": r.randint(0, vocab, (batch, seq), dtype=np.int64),
                "labels": r.randint(0, vocab, (batch, seq), dtype=np.int64)}

    return main, loss, feeds


def build_static_mlp(hidden, depth, seed=7):
    """``bench_static``'s MLP (bench.py:640-652): ``depth`` relu
    ``static.nn.fc`` layers of ``hidden``, a width-1 head, ``mse_loss``
    and ``Adam(1e-3)``; feeds ``x`` ``[None, hidden]`` and ``y`` ``[None,
    1]``.  Parameters on ``get_device()``.  Returns ``(program, loss)``."""
    from .. import optimizer, static
    from ..core import rng

    rng.seed(seed)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, hidden], "float32")
        y = static.data("y", [None, 1], "float32")
        h = x
        for _ in range(depth):
            h = static.nn.fc(h, hidden, activation="relu")
        loss = F.mse_loss(static.nn.fc(h, 1), y)
        optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, loss


def build_static_lenet(seed=9):
    """``bench_static``'s LeNet (bench.py:654-663): ``vision.models.LeNet``
    on ``x`` ``[None, 1, 28, 28]``, ``F.cross_entropy`` against int64
    ``y`` ``[None]``, ``Adam(1e-3)``.  Parameters on ``get_device()``.
    Returns ``(program, loss)``."""
    from .. import optimizer, static
    from ..core import rng
    from ..vision.models import LeNet

    rng.seed(seed)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 1, 28, 28], "float32")
        y = static.data("y", [None], "int64")
        loss = F.cross_entropy(LeNet()(x), y)
        optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, loss


class _Block(nn.Module):
    """``bench.build_gpt``'s pre-norm block: causal attention (the flash
    kernels, with their in-kernel dropout) and a tanh-GELU FFN."""

    def __init__(self, hidden, heads, ffn, dropout, dev):
        super().__init__()
        self.hidden, self.heads, self.dropout = hidden, heads, dropout
        self.ln1 = pnn.LayerNorm(hidden, device=dev)
        self.q = pnn.Linear(hidden, hidden, device=dev)
        self.k = pnn.Linear(hidden, hidden, device=dev)
        self.v = pnn.Linear(hidden, hidden, device=dev)
        self.proj = pnn.Linear(hidden, hidden, device=dev)
        self.ln2 = pnn.LayerNorm(hidden, device=dev)
        self.fc1 = pnn.Linear(hidden, ffn, device=dev)
        self.fc2 = pnn.Linear(ffn, hidden, device=dev)
        self.drop = pnn.Dropout(dropout)

    def forward(self, x):
        B, S = x.shape[0], x.shape[1]
        hd = self.hidden // self.heads
        h = self.ln1(x)
        q = self.q(h).reshape(B, S, self.heads, hd)
        k = self.k(h).reshape(B, S, self.heads, hd)
        v = self.v(h).reshape(B, S, self.heads, hd)
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           dropout_p=self.dropout,
                                           training=self.training)
        x = x + self.drop(self.proj(a.reshape(B, S, self.hidden)))
        h = self.ln2(x)
        return x + self.drop(self.fc2(F.gelu(self.fc1(h), approximate=True)))


class GPT(nn.Module):
    """``bench.build_gpt``'s model: token and position embeddings drawn
    N(0, 0.02) (GPT-2's init: with the tied head it keeps the first
    logits O(1)), embedding dropout, pre-norm blocks each run as a
    recomputed segment (``parallel.recompute``: one block's internals
    live at a time in the backward; ``recompute=False`` keeps them all,
    as a baseline for memory and for the gradients), and a final
    LayerNorm.  The vocab projection is the loss's
    (:func:`gpt_pretrain_loss`), tied to ``tok.weight``."""

    def __init__(self, vocab, hidden, layers, heads, ffn, seq, dropout,
                 device=None, recompute=True):
        super().__init__()
        self.recompute = recompute
        from .. import ParamAttr
        dev = _resolve_device(device)
        self.hidden = hidden
        emb_attr = ParamAttr(initializer=pnn.initializer.Normal(0.0, 0.02))
        self.tok = pnn.Embedding(vocab, hidden, weight_attr=emb_attr,
                                 device=dev)
        self.pos = pnn.Embedding(seq, hidden, weight_attr=emb_attr,
                                 device=dev)
        self.drop = pnn.Dropout(dropout)
        self.blocks = pnn.LayerList([_Block(hidden, heads, ffn, dropout, dev)
                                     for _ in range(layers)])
        self.ln_f = pnn.LayerNorm(hidden, device=dev)

    def forward(self, ids):
        from ..parallel import recompute
        pos_ids = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = self.drop(self.tok(ids) + self.pos(pos_ids))
        for blk in self.blocks:
            x = recompute(blk, x) if self.recompute else blk(x)
        return self.ln_f(x)


class GPTEmbed(nn.Module):
    """The pipelined GPT's first stage: token and position embeddings
    drawn N(0, 0.02), summed, then dropout (``GPT``'s input half)."""

    def __init__(self, vocab, hidden, seq, dropout, device=None):
        super().__init__()
        from .. import ParamAttr
        dev = _resolve_device(device)
        emb_attr = ParamAttr(initializer=pnn.initializer.Normal(0.0, 0.02))
        self.tok = pnn.Embedding(vocab, hidden, weight_attr=emb_attr,
                                 device=dev)
        self.pos = pnn.Embedding(seq, hidden, weight_attr=emb_attr,
                                 device=dev)
        self.drop = pnn.Dropout(dropout)

    def forward(self, ids):
        pos_ids = torch.arange(ids.shape[1], device=ids.device)[None, :]
        return self.drop(self.tok(ids) + self.pos(pos_ids))


class GPTHead(nn.Module):
    """The pipelined GPT's last stage: the final LayerNorm and an untied
    vocab projection, giving the logits."""

    def __init__(self, vocab, hidden, device=None):
        super().__init__()
        dev = _resolve_device(device)
        self.ln_f = pnn.LayerNorm(hidden, device=dev)
        self.out = pnn.Linear(hidden, vocab, device=dev)

    def forward(self, x):
        return self.out(self.ln_f(x))


def build_gpt_pipeline(vocab, hidden, layers, heads, ffn, seq, dropout,
                       device=None):
    """``bench.build_gpt``'s decoder cut for ``parallel.pipeline``:
    ``(stage, embed, head)``, the stage the ``layers`` blocks in a
    ``Sequential`` (one pipeline stage; stack it with
    ``parallel.stack_stage_params``), the embedding the first stage and
    an untied head the last.  Parameter names follow ``GPT``'s blocks."""
    dev = _resolve_device(device)
    stage = pnn.Sequential(*[_Block(hidden, heads, ffn, dropout, dev)
                             for _ in range(layers)])
    return (stage, GPTEmbed(vocab, hidden, seq, dropout, dev),
            GPTHead(vocab, hidden, dev))


def gpt_pipeline_loss(vocab: int):
    """``head_fn(logits, labels)``: the mean next-token cross entropy
    (f32) over the pipeline's logits."""
    def loss_fn(logits, labels):
        return F.cross_entropy(
            torch.Tensor.float(logits.reshape(-1, vocab)),
            labels.reshape(-1))
    return loss_fn


# bench.py:316-321: the single-device presets of bench_gpt
GPT_PRESETS = {
    "760m": dict(vocab=50257, hidden=1536, layers=24, heads=16, ffn=6144,
                 seq=1024, dropout=0.1),
    "1b": dict(vocab=50257, hidden=1792, layers=24, heads=14, ffn=7168,
               seq=1024, dropout=0.1),
}


def build_gpt(vocab, hidden, layers, heads, ffn, seq, dropout,
              device=None, recompute=True) -> GPT:
    """``bench.build_gpt`` with the same arguments, plus ``device`` (the
    current CUDA device by default) and ``recompute``.  Parameter names
    are paddle_tpu's, so the JAX model's state dict loads as it is."""
    return GPT(vocab, hidden, layers, heads, ffn, seq, dropout,
               device=device, recompute=recompute)


def gpt_pretrain_loss(model: GPT, vocab: int):
    """``bench_gpt``'s ``loss_fn(out, labels)`` (bench.py:357-363): the
    tied head ``out @ tok.weight^T`` with a zero bias in the weight's
    type, through the fused, chunked ``linear_cross_entropy`` (the
    ``[tokens, vocab]`` logits never exist whole)."""
    from .. import transpose, zeros

    def loss_fn(out, labels):
        w = transpose(model.tok.weight, [1, 0])
        bias = zeros([vocab], dtype=w.dtype, device=w.device)
        return F.linear_cross_entropy(out.reshape(-1, model.hidden), w, bias,
                                      labels.reshape(-1))
    return loss_fn


class _GPTBlock(nn.Module):
    """``bench.build_gpt``'s pre-norm block with the linears
    tensor-parallel over 'mp' and ring attention over 'sp' (no attention
    dropout: ring rounds merge undropped weights)."""

    def __init__(self, hidden, heads, ffn, dropout, dev):
        super().__init__()
        from ..parallel import ColumnParallelLinear, RowParallelLinear
        self.hidden, self.heads = hidden, heads
        self.ln1 = pnn.LayerNorm(hidden, device=dev)
        self.q = ColumnParallelLinear(hidden, hidden, device=dev)
        self.k = ColumnParallelLinear(hidden, hidden, device=dev)
        self.v = ColumnParallelLinear(hidden, hidden, device=dev)
        self.proj = RowParallelLinear(hidden, hidden, device=dev)
        self.ln2 = pnn.LayerNorm(hidden, device=dev)
        self.fc1 = ColumnParallelLinear(hidden, ffn, device=dev)
        self.fc2 = RowParallelLinear(ffn, hidden, device=dev)
        self.drop = pnn.Dropout(dropout)

    def forward(self, x):
        from ..parallel import ring_attention
        B, S = x.shape[0], x.shape[1]
        hd = self.hidden // self.heads
        h = self.ln1(x)
        q = self.q(h).reshape(B, S, self.heads, hd)
        k = self.k(h).reshape(B, S, self.heads, hd)
        v = self.v(h).reshape(B, S, self.heads, hd)
        a = ring_attention(q, k, v, is_causal=True)
        x = x + self.drop(self.proj(a.reshape(B, S, self.hidden)))
        h = self.ln2(x)
        return x + self.drop(self.fc2(F.gelu(self.fc1(h), approximate=True)))


class GPTHybrid(nn.Module):
    def __init__(self, vocab, hidden, layers, heads, ffn, seq, dropout,
                 device=None):
        super().__init__()
        dev = _resolve_device(device)
        self.hidden = hidden
        # GPT-2 init, as bench.build_gpt: N(0, 0.02) embeddings
        emb_attr = ParamAttr(initializer=pnn.initializer.Normal(0.0, 0.02))
        self.tok = pnn.Embedding(vocab, hidden, weight_attr=emb_attr,
                                 device=dev)
        self.pos = pnn.Embedding(seq, hidden, weight_attr=emb_attr,
                                 device=dev)
        self.drop = pnn.Dropout(dropout)
        self.blocks = pnn.LayerList([_GPTBlock(hidden, heads, ffn, dropout,
                                               dev) for _ in range(layers)])
        self.ln_f = pnn.LayerNorm(hidden, device=dev)

    def forward(self, ids):
        pos_ids = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = self.drop(self.tok(ids) + self.pos(pos_ids))
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


def build_gpt_hybrid(vocab, hidden, layers, heads, ffn, seq, dropout,
                     device=None) -> GPTHybrid:
    """``bench.build_gpt`` (bench.py:239-300) over the installed mesh:
    parameter names are paddle_tpu's, the TP layers hold this rank's
    shards.  No per-block recompute (:func:`build_gpt` has it)."""
    return GPTHybrid(vocab, hidden, layers, heads, ffn, seq, dropout,
                     device=device)


def gpt_loss(model: GPTHybrid):
    """``bench_gpt``'s ``loss_fn(out, labels)``: the tied head (``out @
    tok.weight^T``, zero bias) through the fused, chunked
    ``linear_cross_entropy``."""
    def loss_fn(out, labels):
        return F.linear_cross_entropy(out.reshape(-1, model.hidden),
                                      model.tok.weight.t(), None,
                                      labels.reshape(-1))
    return loss_fn


def gpt_flops_per_step(vocab, hidden, layers, seq, batch, ffn) -> int:
    """``bench_gpt``'s model FLOPs per step (bench.py:380-388): 6 N T
    over the matmul parameters (the blocks' and the tied vocab
    projection) plus 6 L B S^2 H for causal attention."""
    per_layer = 4 * hidden * hidden + 2 * hidden * ffn + 9 * hidden + ffn
    n_matmul = layers * per_layer + 2 * hidden + vocab * hidden
    return (6 * n_matmul * batch * seq
            + 6 * layers * batch * seq ** 2 * hidden)


def sinusoid_positions(max_len, d_model) -> np.ndarray:
    """Vaswani et al.'s position table, ``[max_len, d_model]`` f32:
    sin(pos / 10000^(2i/d)) at 2i, cos at 2i + 1."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    rate = 10000.0 ** (-np.arange(0, d_model, 2, dtype=np.float64) / d_model)
    table = np.zeros((max_len, d_model), np.float64)
    table[:, 0::2] = np.sin(pos * rate)
    table[:, 1::2] = np.cos(pos * rate)
    return table.astype(np.float32)


class TransformerNMT(paddle.nn.Layer):
    """Encoder-decoder translation model with a vocabulary shared by the
    source and the target: ``model(src, tgt_in)`` -> logits ``[B, T,
    vocab]`` under the causal target mask.  The embedding is drawn from
    N(0, d_model^-0.5); the position table is a buffer outside the
    state dict, so a state dict holds ``embedding.weight`` and the
    ``transformer.*`` parameters only."""

    def __init__(self, vocab, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 max_len=256, device=None):
        super().__init__()
        self.vocab, self.d_model = vocab, d_model
        self.embedding = paddle.nn.Embedding(
            vocab, d_model, weight_attr=paddle.ParamAttr(
                initializer=paddle.nn.initializer.Normal(
                    0.0, d_model ** -0.5)),
            device=device)
        self.transformer = paddle.nn.Transformer(
            d_model, nhead, num_encoder_layers, num_decoder_layers,
            dim_feedforward, dropout, device=device)
        self.dropout = paddle.nn.Dropout(dropout)
        self.register_buffer("positions", paddle.to_tensor(
            sinusoid_positions(max_len, d_model),
            place=self.embedding.weight.device), persistable=False)

    def embed(self, ids, offset=0):
        """Scaled embeddings plus positions ``offset ...``, dropped."""
        x = self.embedding(ids) * math.sqrt(self.d_model)
        return self.dropout(x + self.positions[offset:offset + ids.shape[1]])

    def encode(self, src):
        return self.transformer.encoder(self.embed(src))

    def logits(self, h):
        """The output projection, tied to the embedding."""
        return paddle.matmul(h, self.embedding.weight, transpose_y=True)

    def forward(self, src, tgt):
        mask = paddle.nn.Transformer.generate_square_subsequent_mask(
            tgt.shape[1], device=tgt.device)
        h = self.transformer(self.embed(src), self.embed(tgt),
                             tgt_mask=mask)
        return self.logits(h)


def nmt_loss(vocab, epsilon=0.1):
    """``loss_fn(logits, labels)``: the cross entropy against the
    label-smoothed one-hot targets (section 5.4), mean over tokens."""
    def loss_fn(logits, labels):
        F = paddle.nn.functional
        soft = F.label_smooth(F.one_hot(labels.reshape([-1]), vocab),
                              epsilon=epsilon)
        return F.cross_entropy(logits.reshape([-1, vocab]), soft,
                               soft_label=True)
    return loss_fn


def greedy_decode(model: TransformerNMT, src, max_len, bos):
    """Greedy decoding of ``max_len`` tokens after ``bos``: the encoder
    runs once, the decoder one token a step over its caches (the
    self-attention's grows by a key a step, the cross-attention's holds
    the source's).  Returns ``(tokens [B, max_len], logits [B, max_len,
    vocab])``; runs in eval mode without autograd."""
    was_training = model.training
    model.eval()
    try:
        with paddle.no_grad():
            memory = model.encode(src)
            cache = model.transformer.decoder.gen_cache(memory)
            tok = paddle.zeros_like(src[:, :1]) + bos
            toks, logits = [], []
            for t in range(max_len):
                h, cache = model.transformer.decoder(model.embed(tok, t),
                                                     memory, cache=cache)
                lg = model.logits(h)
                tok = paddle.argmax(lg, axis=-1)
                toks.append(tok)
                logits.append(lg)
    finally:
        model.train(was_training)
    return paddle.concat(toks, axis=1), paddle.concat(logits, axis=1)


def nmt_flops_per_step(vocab, d_model, enc_layers, dec_layers, ffn, batch,
                       src_len, tgt_len) -> int:
    """Model FLOPs of one training step of :class:`TransformerNMT` (3x
    the forward): the projections and FFNs (the cross-attention's keys
    and values over the source), the tied head, and the attention
    products (QK^T and PV, unmasked counted whole)."""
    d, f = d_model, ffn
    src, tgt = batch * src_len, batch * tgt_len
    enc = 2 * src * (4 * d * d + 2 * d * f)
    dec = 2 * tgt * (6 * d * d + 2 * d * f) + 2 * src * 2 * d * d
    attn = 4 * batch * d * (enc_layers * src_len ** 2 + dec_layers * (
        tgt_len ** 2 + tgt_len * src_len))
    head = 2 * tgt * d * vocab
    return 3 * (enc_layers * enc + dec_layers * dec + attn + head)
