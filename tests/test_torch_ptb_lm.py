"""Zaremba et al.'s PTB LSTM language model (arXiv:1409.2329, section
4.1), built from each package's public ``nn`` API at small widths, the
port against paddle_tpu on the CPU: a sparse embedding, two separate
LSTM layers with dropout around them (0 here), a Linear head and the
mean cross entropy; the final (h, c) of a step feeds the next step's
initial states, detached (truncated BPTT).  Three steps of sparse SGD
with a global-norm clip of 10, then three of ``Adam(lazy_mode=True)``,
from the same U(-0.04, 0.04) numpy weights and Zipf-drawn ids: the
losses agree within 1e-5 relative, the untouched embedding rows stay
bitwise as they were on the port, and the final weights agree."""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement

VOCAB, HIDDEN, STEPS, BATCH = 200, 32, 8, 4


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


class PTBLM:
    """The model, from ``pkg``'s public nn API."""

    def __init__(self, pkg, vocab, hidden, dropout):
        nn = pkg.nn
        self.pkg = pkg
        self.layers = {"embedding": nn.Embedding(vocab, hidden, sparse=True),
                       "lstm1": nn.LSTM(hidden, hidden),
                       "lstm2": nn.LSTM(hidden, hidden),
                       "head": nn.Linear(hidden, vocab)}
        self.drops = [nn.Dropout(dropout) for _ in range(3)]
        self.vocab = vocab

    def parameters(self):
        return [p for k in sorted(self.layers)
                for _, p in sorted(self.layers[k].named_parameters())]

    def __call__(self, x, y, states):
        L, F = self.layers, self.pkg.nn.functional
        h = self.drops[0](L["embedding"](x))
        h, s1 = L["lstm1"](h, states[0])
        h, s2 = L["lstm2"](self.drops[1](h), states[1])
        logits = L["head"](self.drops[2](h))
        loss = F.cross_entropy(logits.reshape([-1, self.vocab]),
                               y.reshape([-1]))
        return loss, [s1, s2]


def zipf_ids(seed, vocab, batch, steps):
    """``[batch, steps + 1]`` ids drawn with p proportional to
    1 / rank."""
    p = 1.0 / np.arange(1, vocab + 1)
    return np.random.RandomState(seed).choice(
        vocab, size=(batch, steps + 1), p=p / p.sum()).astype(np.int64)


def _weights(model, seed):
    rs = np.random.RandomState(seed)
    return [rs.uniform(-0.04, 0.04, tuple(p.shape)).astype(np.float32)
            for p in model.parameters()]


def _train(pkg, weights, batches, clip=10.0):
    model = PTBLM(pkg, VOCAB, HIDDEN, 0.0)
    for p, w in zip(model.parameters(), weights):
        p.set_value(w)
    emb0 = model.layers["embedding"].weight.numpy().copy()
    zeros = np.zeros((1, BATCH, HIDDEN), np.float32)
    states = [(pkg.to_tensor(zeros), pkg.to_tensor(zeros))] * 2
    opts = [pkg.optimizer.SGD(
                learning_rate=1.0, parameters=model.parameters(),
                grad_clip=pkg.nn.ClipGradByGlobalNorm(clip)),
            pkg.optimizer.Adam(learning_rate=1e-3, lazy_mode=True,
                               parameters=model.parameters())]
    losses = []
    for k, ids in enumerate(batches):
        opt = opts[k // 3]
        loss, states = model(pkg.to_tensor(ids[:, :-1]),
                             pkg.to_tensor(ids[:, 1:]), states)
        states = [(h.detach(), c.detach()) for h, c in states]
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, model, emb0


def test_ptb_lm_trajectory_matches(cpu):
    model = PTBLM(paddle_tpu_torch, VOCAB, HIDDEN, 0.0)
    weights = _weights(model, 0)
    batches = [zipf_ids(100 + k, VOCAB, BATCH, STEPS) for k in range(6)]
    jl, jm, _ = _train(paddle_tpu, weights, batches)
    tl, tm, emb0 = _train(paddle_tpu_torch, weights, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert abs(tl[0] - np.log(VOCAB)) < 0.02 * np.log(VOCAB)
    for a, b in zip(tm.parameters(), jm.parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    emb = tm.layers["embedding"].weight.numpy()
    untouched = np.setdiff1d(np.arange(VOCAB), np.concatenate(
        [b[:, :-1].ravel() for b in batches]))
    assert untouched.size > 0
    np.testing.assert_array_equal(emb[untouched], emb0[untouched])


def test_zipf_ids_touch_a_few_rows():
    """The draw PTB-large's phase uses: at its 10000 words and 35 x 20
    tokens a batch touches a few hundred rows, as PTB text does."""
    ids = zipf_ids(0, 10000, 20, 35)
    assert ids.shape == (20, 36)
    assert 150 < np.unique(ids[:, :-1]).size < 600
