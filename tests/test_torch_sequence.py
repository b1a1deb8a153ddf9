"""The sequence ops of the port against paddle_tpu's, on the CPU (the
sequence cases of ``tests/test_detection_sequence.py``): the same
padded values and lengths give the same outputs (rtol 1e-5 / atol
1e-6; ids and lengths exactly) and, for the differentiable ops, the
same input gradients; plus ``test_text_e2e.py``'s ``LstmClassifier``
(an LSTM over embeddings, averaged by ``sequence_pool``)."""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.ops import sequence as JSEQ
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.ops import sequence as TSEQ

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _np(x):
    return np.asarray(x.numpy())


def _both(fn, *arrays, grad=None):
    """``fn(SEQ, pkg, *tensors)`` on both packages: outputs (and, with
    ``grad`` the indexes of float inputs, their gradients of a weighted
    sum of the first output) as numpy."""
    res = []
    for seq, pkg in ((JSEQ, paddle_tpu), (TSEQ, paddle_tpu_torch)):
        ts = [pkg.to_tensor(a, stop_gradient=not (grad and i in grad))
              for i, a in enumerate(arrays)]
        out = fn(seq, pkg, *ts)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        got = [_np(o) for o in outs]
        if grad:
            w = np.random.RandomState(9).randn(*got[0].shape).astype(
                "float32")
            (outs[0] * pkg.to_tensor(w)).sum().backward()
            got += [_np(ts[i].grad) for i in grad]
        res.append(got)
    return res


def _same(res):
    for a, b in zip(*res):
        if np.issubdtype(np.asarray(a).dtype, np.integer):
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_sequence_pad_unpad_roundtrip(cpu):
    flat = np.arange(12, dtype=np.float32).reshape(6, 2)
    lens = np.array([2, 1, 3], np.int64)
    res = _both(lambda S, P, x, l: S.sequence_pad(x, l, maxlen=4,
                                                  pad_value=-1.0),
                flat, lens)
    _same(res)
    assert res[1][0].shape == (3, 4, 2)
    # the port's pad is differentiable (a kept difference: paddle_tpu's
    # wraps its input anew and gives no gradient): each packed row gets
    # the weight of the slot it went to
    x = paddle_tpu_torch.to_tensor(flat, stop_gradient=False)
    w = np.random.RandomState(9).randn(3, 4, 2).astype("float32")
    out, _ = TSEQ.sequence_pad(x, paddle_tpu_torch.to_tensor(lens), 4, -1.0)
    (out * paddle_tpu_torch.to_tensor(w)).sum().backward()
    want = np.concatenate([w[i, :n] for i, n in enumerate(lens)])
    np.testing.assert_array_equal(_np(x.grad), want)
    padded = TSEQ.sequence_pad(paddle_tpu_torch.to_tensor(flat),
                               paddle_tpu_torch.to_tensor(lens))[0]
    assert padded.shape == [3, 3, 2]
    back = TSEQ.sequence_unpad(padded, paddle_tpu_torch.to_tensor(lens))
    np.testing.assert_array_equal(_np(back), flat)


@pytest.mark.parametrize("mode", ["sum", "average", "sqrt", "max", "first",
                                  "last"])
def test_sequence_pool_all_modes(cpu, mode):
    x = np.random.RandomState(8).randn(4, 5, 2).astype(np.float32)
    lens = np.array([3, 5, 1, 0], np.int64)
    res = _both(lambda S, P, x, l: S.sequence_pool(x, l, mode,
                                                   pad_value=7.0),
                x, lens, grad=[0])
    _same(res)
    assert np.all(res[1][0][3] == 7.0)       # the empty row pools to pad


def test_first_and_last_step(cpu):
    x = np.random.RandomState(8).randn(3, 5, 2).astype(np.float32)
    lens = np.array([3, 5, 1], np.int64)
    _same(_both(lambda S, P, x, l: (S.sequence_first_step(x, l),
                                    S.sequence_last_step(x, l)), x, lens))


def test_sequence_softmax_and_reverse(cpu):
    x = np.random.RandomState(9).randn(2, 4).astype(np.float32)
    lens = np.array([3, 2], np.int64)
    _same(_both(lambda S, P, x, l: S.sequence_softmax(x, l), x, lens,
                grad=[0]))
    x3 = np.random.RandomState(9).randn(2, 4, 3).astype(np.float32)
    _same(_both(lambda S, P, x, l: S.sequence_reverse(x, l), x3, lens))
    # differentiable in the port (paddle_tpu's gives no gradient): the
    # gradient is the weight reversed the same way
    xt = paddle_tpu_torch.to_tensor(x3, stop_gradient=False)
    w = np.random.RandomState(9).randn(*x3.shape).astype("float32")
    lt = paddle_tpu_torch.to_tensor(lens)
    (TSEQ.sequence_reverse(xt, lt) * paddle_tpu_torch.to_tensor(w)).sum(
        ).backward()
    np.testing.assert_array_equal(
        _np(xt.grad), _np(TSEQ.sequence_reverse(
            paddle_tpu_torch.to_tensor(w), lt)))
    _same(_both(lambda S, P, x: S.sequence_reverse(x), x3))


def test_sequence_concat_slice_erase_enumerate(cpu):
    a = np.array([[1, 2, 0], [3, 0, 0]], np.int64)
    b = np.array([[7, 8], [9, 0]], np.int64)
    la, lb = np.array([2, 1], np.int64), np.array([2, 1], np.int64)
    res = _both(lambda S, P, a, b, la, lb: S.sequence_concat([a, b],
                                                             [la, lb]),
                a, b, la, lb)
    _same(res)
    np.testing.assert_array_equal(res[1][1], [4, 2])
    af = np.random.RandomState(3).randn(2, 3, 2).astype(np.float32)
    bf = np.random.RandomState(4).randn(2, 2, 2).astype(np.float32)
    _same(_both(lambda S, P, a, b, la, lb: S.sequence_concat([a, b],
                                                             [la, lb]),
                af, bf, la, lb, grad=[0, 1]))

    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    res = _both(lambda S, P, x, o, n: S.sequence_slice(x, o, n), x,
                np.array([1, 2], np.int64), np.array([3, 2], np.int64),
                grad=[0])
    _same(res)

    ids = np.array([[4, 2, 4, 7, 0]], np.int64)
    lens = np.array([4], np.int64)
    res = _both(lambda S, P, x, l: S.sequence_erase(x, [4], l), ids, lens)
    _same(res)
    np.testing.assert_array_equal(res[1][0][0, :2], [2, 7])
    _same(_both(lambda S, P, x: S.sequence_erase(x, [4, 0]), ids))
    res = _both(lambda S, P, x, l: S.sequence_enumerate(x, 2, pad_value=-1,
                                                        lengths=l),
                ids, lens)
    _same(res)
    assert res[1][0].shape == (1, 5, 2)
    _same(_both(lambda S, P, x: S.sequence_enumerate(x, 3), ids))


@pytest.mark.parametrize("bias", [False, True])
def test_sequence_conv(cpu, bias):
    rs = np.random.RandomState(10)
    x = rs.randn(2, 5, 3).astype(np.float32)
    lens = np.array([4, 5], np.int64)
    w = rs.randn(9, 4).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    if bias:
        _same(_both(lambda S, P, x, l, w, b: S.sequence_conv(
            x, l, w, b, context_length=3), x, lens, w, b, grad=[0, 2, 3]))
    else:
        _same(_both(lambda S, P, x, l, w: S.sequence_conv(
            x, l, w, context_length=3, context_start=0), x, lens, w,
            grad=[0, 2]))


def test_sequence_expand_as_and_mask(cpu):
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    lens = np.array([2, 1], np.int64)
    _same(_both(lambda S, P, x, l: S.sequence_expand_as(x, l, maxlen=3),
                x, lens, grad=[0]))
    res = _both(lambda S, P, l: S.sequence_mask(l, 4), lens)
    _same(res)
    res = _both(lambda S, P, l: P.nn.functional.sequence_mask(
        l, dtype="float32"), lens)
    _same(res)
    assert res[1][0].dtype == np.float32 and res[1][0].shape == (2, 2)


class _LstmClassifier:
    """test_text_e2e.py's LstmClassifier, built from either package."""

    def __init__(self, pkg, vocab, emb=32, hidden=32, classes=2):
        self.pkg = pkg
        self.embedding = pkg.nn.Embedding(vocab, emb)
        self.lstm = pkg.nn.LSTM(emb, hidden)
        self.head = pkg.nn.Linear(hidden, classes)
        self.layers = {"embedding": self.embedding, "lstm": self.lstm,
                       "head": self.head}

    def __call__(self, ids, seq):
        x = self.embedding(ids)
        out, _ = self.lstm(x)
        lens = self.pkg.to_tensor(
            np.full((ids.shape[0],), ids.shape[1], np.int64))
        return self.head(seq.sequence_pool(out, lens, "average"))


def test_lstm_classifier_matches(cpu):
    """Logits, loss and every gradient of the IMDB classifier."""
    jm = _LstmClassifier(paddle_tpu, 50)
    tm = _LstmClassifier(paddle_tpu_torch, 50)
    for k, jl in jm.layers.items():
        sd = {n: np.asarray(v.data) for n, v in jl.state_dict().items()}
        tm.layers[k].set_state_dict(state_dict_from_paddle_tpu(
            sd, "cpu", tm.layers[k]))
    rs = np.random.RandomState(12)
    ids = rs.randint(0, 50, (4, 9)).astype(np.int64)
    y = rs.randint(0, 2, (4,)).astype(np.int64)
    got = []
    for m, pkg, seq in ((jm, paddle_tpu, JSEQ),
                        (tm, paddle_tpu_torch, TSEQ)):
        logits = m(pkg.to_tensor(ids), seq)
        loss = pkg.nn.functional.cross_entropy(logits, pkg.to_tensor(y))
        loss.backward()
        got.append([_np(logits), float(loss)] + [
            _np(p.grad) for k in ("embedding", "lstm", "head")
            for _, p in sorted(m.layers[k].named_parameters())])
    for a, b in zip(*got):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
