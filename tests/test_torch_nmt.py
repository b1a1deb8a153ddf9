"""The translation model (``testing.models.TransformerNMT``: Vaswani et
al. 2017, sections 3.4-3.5) at small widths, the port against its twin
built here from paddle_tpu's public API, on the CPU from the same
weights (carried by ``state_dict``) and Zipf-drawn ids: three
``TrainStep``s of Adam (beta 0.9 / 0.98, epsilon 1e-9) under
``NoamDecay`` with label smoothing 0.1 at dropout 0, losses within 1e-5
relative and every final weight within 1e-5 of its tensor's largest
magnitude.  Adam at epsilon 1e-9 turns a gradient that is zero up to
rounding into a step of about lr, of either sign: the key projections'
biases (softmax ignores a shift shared by every key, as ROADMAP's kept
differences say) and at most 0.5 % of a tensor's elements (1 of 1024 in
two tensors here) may therefore differ by up to twice the summed
learning rates, and no more; then greedy decoding through the decoder's caches, ids equal and
logits within 1e-5, and equal to the full forward's at every
position."""
import math

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.testing.models import (TransformerNMT, greedy_decode,
                                             nmt_flops_per_step, nmt_loss,
                                             sinusoid_positions)

VOCAB, D, HEADS, FFN, LAYERS = 64, 32, 4, 64, 2
BATCH, SRC, TGT, WARMUP = 4, 7, 6, 4


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield
    placement.set_default(prev)


class JaxNMT(paddle_tpu.nn.Layer):
    """TransformerNMT's twin from paddle_tpu's public API."""

    def __init__(self):
        super().__init__()
        P = paddle_tpu
        self.embedding = P.nn.Embedding(VOCAB, D, weight_attr=P.ParamAttr(
            initializer=P.nn.initializer.Normal(0.0, D ** -0.5)))
        self.transformer = P.nn.Transformer(D, HEADS, LAYERS, LAYERS, FFN,
                                            dropout=0.0)
        self.table = sinusoid_positions(64, D)

    def embed(self, ids, offset=0):
        pos = paddle_tpu.to_tensor(self.table[offset:offset + ids.shape[1]])
        return self.embedding(ids) * math.sqrt(D) + pos

    def logits(self, h):
        return paddle_tpu.matmul(h, self.embedding.weight, transpose_y=True)

    def forward(self, src, tgt):
        mask = paddle_tpu.nn.Transformer.generate_square_subsequent_mask(
            tgt.shape[1])
        return self.logits(self.transformer(self.embed(src),
                                            self.embed(tgt), tgt_mask=mask))


def _jax_greedy(model, src, n, bos):
    memory = model.transformer.encoder(model.embed(src))
    cache = model.transformer.decoder.gen_cache(memory)
    tok = paddle_tpu.full([src.shape[0], 1], bos, dtype="int64")
    toks, logits = [], []
    for t in range(n):
        h, cache = model.transformer.decoder(model.embed(tok, t), memory,
                                             cache=cache)
        lg = model.logits(h)
        tok = paddle_tpu.argmax(lg, axis=-1)
        toks.append(np.asarray(tok.numpy()))
        logits.append(np.asarray(lg.numpy()))
    return np.concatenate(toks, 1), np.concatenate(logits, 1)


def _zipf(seed, shape):
    p = 1.0 / np.arange(1, VOCAB + 1)
    return np.random.RandomState(seed).choice(
        VOCAB, size=shape, p=p / p.sum()).astype(np.int64)


def _models():
    paddle_tpu.seed(7)
    jm = JaxNMT()
    tm = TransformerNMT(VOCAB, D, HEADS, LAYERS, LAYERS, FFN, dropout=0.0,
                        max_len=64)
    sd = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
    tm.set_state_dict(state_dict_from_paddle_tpu(sd, "cpu", tm))
    return jm, tm


def _train(pkg, model, batches):
    sched = pkg.optimizer.lr.NoamDecay(d_model=D, warmup_steps=WARMUP,
                                       learning_rate=1.0)
    opt = pkg.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                             epsilon=1e-9, parameters=model.parameters())
    loss_fn = (nmt_loss(VOCAB) if pkg is paddle_tpu_torch else
               _jax_loss(VOCAB))
    step = pkg.jit.TrainStep(model, loss_fn, opt, n_inputs=2)
    losses, lrs = [], []
    for src, tgt in batches:
        lrs.append(opt.get_lr())
        losses.append(float(step(pkg.to_tensor(src),
                                 pkg.to_tensor(tgt[:, :-1]),
                                 pkg.to_tensor(tgt[:, 1:]))))
        sched.step()
    return losses, lrs


def _jax_loss(vocab):
    F = paddle_tpu.nn.functional

    def loss_fn(logits, labels):
        soft = F.label_smooth(F.one_hot(labels.reshape([-1]), vocab),
                              epsilon=0.1)
        return F.cross_entropy(logits.reshape([-1, vocab]), soft,
                               soft_label=True)
    return loss_fn


def test_three_adam_noam_steps_match_paddle_tpu(cpu):
    jm, tm = _models()
    assert list(tm.state_dict()) == list(jm.state_dict())
    sd0 = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    batches = [(_zipf(10 + k, (BATCH, SRC)), _zipf(20 + k, (BATCH, TGT + 1)))
               for k in range(3)]
    jl, lrs = _train(paddle_tpu, jm, batches)
    tl, tlrs = _train(paddle_tpu_torch, tm, batches)
    np.testing.assert_allclose(tlrs, lrs, rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # the first loss against the uniform prediction's, ln V (the smoothed
    # target sums to 1): the tied head's logits have unit variance, so
    # the expected loss is ln V + 1/2
    assert abs(tl[0] - (math.log(VOCAB) + 0.5)) < 0.5
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    moved, adam_bound = 0, 2 * sum(lrs)
    for k, v in tm.state_dict().items():
        got, ref = v.numpy(), jsd[k]
        moved += np.abs(got - sd0[k]).max() > 1e-3
        err = np.abs(got - ref)
        assert err.max() <= adam_bound, k
        if not k.endswith("k_proj.bias"):
            outliers = err > 1e-5 * max(1.0, np.abs(ref).max())
            assert outliers.sum() <= 0.005 * err.size, k
    assert moved == len(sd0)         # Noam's early steps move every weight


def test_greedy_decode_matches_paddle_tpu_and_the_full_forward(cpu):
    jm, tm = _models()
    src = _zipf(30, (BATCH, SRC))
    toks, logits = greedy_decode(tm, paddle_tpu_torch.to_tensor(src), 6, 1)
    jtoks, jlogits = _jax_greedy(jm, paddle_tpu.to_tensor(src), 6, 1)
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5,
                               atol=1e-5)
    tgt_in = np.concatenate([np.ones((BATCH, 1), np.int64),
                             toks.numpy()[:, :-1]], 1)
    tm.eval()
    full = tm(paddle_tpu_torch.to_tensor(src),
              paddle_tpu_torch.to_tensor(tgt_in)).numpy()
    np.testing.assert_allclose(logits.numpy(), full, rtol=1e-5, atol=1e-5)
    assert tm.training is False


def test_sinusoid_table_and_the_step_count():
    t = sinusoid_positions(50, 16)
    pos, i = 37, 3
    assert t[pos, 2 * i] == pytest.approx(
        math.sin(pos / 10000 ** (2 * i / 16)), abs=1e-6)
    assert t[pos, 2 * i + 1] == pytest.approx(
        math.cos(pos / 10000 ** (2 * i / 16)), abs=1e-6)
    # Transformer-base at 64 x 64 tokens a side: encoder 2 T 18.9M,
    # decoder 2 T 25.2M, head 2 T d V and 18 attentions of 4 B L^2 d
    fwd = (2 * 4096 * 6 * (4 * 512 ** 2 + 2 * 512 * 2048)
           + 2 * 4096 * 6 * (8 * 512 ** 2 + 2 * 512 * 2048)
           + 2 * 4096 * 512 * 37000 + 18 * 4 * 64 * 64 ** 2 * 512)
    assert nmt_flops_per_step(37000, 512, 6, 6, 2048, 64, 64, 64) == 3 * fwd
    assert 1.57e12 < 3 * fwd < 1.58e12
