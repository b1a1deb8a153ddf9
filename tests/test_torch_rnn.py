"""The recurrent layers and cells of the port against paddle_tpu's, on
the CPU: the same numpy weights (carried by name through
``state_dict_from_paddle_tpu``) and inputs give the same outputs, final
states, and gradients of every parameter and of the input, at rtol 1e-5
/ atol 1e-6, through torch's fused recurrent op and through the
per-step version alike.  paddle_tpu's departures from upstream Paddle
are pinned: ``dropout`` and ``sequence_length`` are ignored."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu

RTOL, ATOL = 1e-5, 1e-6
IN, HID, B, T = 5, 7, 3, 4


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _pair(make):
    """(JAX layer, port layer) with the JAX layer's weights."""
    jl = make(paddle_tpu.nn)
    tl = make(paddle_tpu_torch.nn)
    sd = {k: np.asarray(v.data) for k, v in jl.state_dict().items()}
    tl.set_state_dict(state_dict_from_paddle_tpu(sd, "cpu", tl))
    return jl, tl


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _flat(v)]
    return [x]


def _run(pkg, layer, x, states, weights):
    """Outputs, states and the gradients of a weighted sum of them with
    respect to the input and every parameter."""
    xt = pkg.to_tensor(x, stop_gradient=False)
    st = None if states is None else (
        tuple(pkg.to_tensor(s) for s in states) if isinstance(states, tuple)
        else pkg.to_tensor(states))
    out, fin = layer(xt, st)
    outs = _flat([out, fin])
    loss = sum((o * pkg.to_tensor(w)).sum() for o, w in zip(outs, weights))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    return [o.numpy() for o in outs], xt.grad.numpy(), grads


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _compare(jl, tl, x, states):
    rs = np.random.RandomState(1)
    probe = tl(paddle_tpu_torch.to_tensor(x), None if states is None else (
        tuple(paddle_tpu_torch.to_tensor(s) for s in states)
        if isinstance(states, tuple) else paddle_tpu_torch.to_tensor(states)))
    weights = [rs.randn(*o.shape).astype("float32")
               for o in _flat(list(probe))]
    jo, jx, jg = _run(paddle_tpu, jl, x, states, weights)
    to, tx, tg = _run(paddle_tpu_torch, tl, x, states, weights)
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        _close(a, b)
    _close(tx, jx)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _close(tg[k], jg[k])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_fused_layers_match(cpu, cls, num_layers, direction, time_major,
                            fused):
    """Outputs, final states and all gradients; initial states given at
    2 layers, zeros at 1."""
    jl, tl = _pair(lambda nn: getattr(nn, cls)(
        IN, HID, num_layers=num_layers, direction=direction,
        time_major=time_major))
    tl.fused = fused
    rs = np.random.RandomState(0)
    x = rs.randn(*((T, B, IN) if time_major else (B, T, IN))).astype(
        "float32")
    states = None
    if num_layers == 2:
        n = num_layers * (2 if direction == "bidirect" else 1)
        h = rs.randn(n, B, HID).astype("float32")
        states = (h, rs.randn(n, B, HID).astype("float32")) \
            if cls == "LSTM" else h
    _compare(jl, tl, x, states)


def test_parameter_names_and_init(cpu):
    """paddle_tpu's names, shapes and U(-1/sqrt(H), 1/sqrt(H)) init."""
    j = paddle_tpu.nn.GRU(IN, HID, num_layers=2, direction="bidirectional")
    t = paddle_tpu_torch.nn.GRU(IN, HID, num_layers=2,
                                direction="bidirectional")
    js = {k: tuple(v.shape) for k, v in j.state_dict().items()}
    ts = {k: tuple(v.shape) for k, v in t.state_dict().items()}
    assert ts == js
    assert "weight_ih_l1_reverse" in ts and ts["weight_ih_l1"] == (21, 14)
    bound = 1 / np.sqrt(HID)
    for p in t.parameters():
        assert float(p.abs().max()) <= bound


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "SimpleRNNCell_relu",
                                  "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("with_states", [False, True])
def test_cells_match(cpu, cell, with_states):
    name, _, act = cell.partition("_")
    kw = {"activation": act} if act else {}
    jl, tl = _pair(lambda nn: getattr(nn, name)(IN, HID, **kw))
    rs = np.random.RandomState(2)
    x = rs.randn(B, IN).astype("float32")
    states = None
    if with_states:
        h = rs.randn(B, HID).astype("float32")
        states = (h, rs.randn(B, HID).astype("float32")) \
            if name == "LSTMCell" else h
    _compare(jl, tl, x, states)


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_rnn_and_birnn_over_cells_match(cpu, cell, time_major):
    """``RNN(cell)`` forward and reversed, and ``BiRNN``."""
    rs = np.random.RandomState(3)
    x = rs.randn(*((T, B, IN) if time_major else (B, T, IN))).astype(
        "float32")
    for make in (
            lambda nn: nn.RNN(getattr(nn, cell)(IN, HID),
                              time_major=time_major),
            lambda nn: nn.RNN(getattr(nn, cell)(IN, HID), is_reverse=True,
                              time_major=time_major),
            lambda nn: nn.BiRNN(getattr(nn, cell)(IN, HID),
                                getattr(nn, cell)(IN, HID),
                                time_major=time_major)):
        jl, tl = _pair(make)
        _compare(jl, tl, x, None)


def test_fused_layer_equals_rnn_over_its_cells(cpu):
    """A one-layer LSTM and ``RNN(LSTMCell)`` with the same weights."""
    torch.manual_seed(0)
    lstm = paddle_tpu_torch.nn.LSTM(IN, HID)
    cell = paddle_tpu_torch.nn.LSTMCell(IN, HID)
    for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        getattr(cell, k).set_value(getattr(lstm, f"{k}_l0").numpy())
    x = paddle_tpu_torch.to_tensor(
        np.random.RandomState(4).randn(B, T, IN).astype("float32"))
    y, (h, c) = lstm(x)
    y2, (h2, c2) = paddle_tpu_torch.nn.RNN(cell)(x)
    for a, b in ((y, y2), (h[0], h2), (c[0], c2)):
        _close(a.numpy(), b.numpy())


def test_dropout_and_sequence_length_are_ignored(cpu):
    """As in paddle_tpu: a 2-layer LSTM with ``dropout=0.5`` in training
    mode, given ``sequence_length``, gives what ``dropout=0`` without
    lengths gives, and both packages agree."""
    jl, tl = _pair(lambda nn: nn.LSTM(IN, HID, num_layers=2, dropout=0.5))
    _, tl0 = _pair(lambda nn: nn.LSTM(IN, HID, num_layers=2))
    tl0.set_state_dict(tl.state_dict())
    tl.train()
    x = np.random.RandomState(5).randn(B, T, IN).astype("float32")
    lens = np.array([1, 2, 4], "int64")
    out, (h, c) = tl(paddle_tpu_torch.to_tensor(x),
                     sequence_length=paddle_tpu_torch.to_tensor(lens))
    out0, (h0, c0) = tl0(paddle_tpu_torch.to_tensor(x))
    jout, (jh, jc) = jl(paddle_tpu.to_tensor(x),
                        sequence_length=paddle_tpu.to_tensor(lens))
    np.testing.assert_array_equal(out.numpy(), out0.numpy())
    np.testing.assert_array_equal(h.numpy(), h0.numpy())
    _close(out.numpy(), jout.numpy())
    _close(c.numpy(), jc.numpy())
    # the padded steps of the short rows are computed, not masked
    assert np.abs(out.numpy()[0, 1:]).sum() > 0
    bi = paddle_tpu_torch.nn.BiRNN(paddle_tpu_torch.nn.GRUCell(IN, HID),
                                   paddle_tpu_torch.nn.GRUCell(IN, HID))
    y, _ = bi(paddle_tpu_torch.to_tensor(x))
    y2, _ = bi(paddle_tpu_torch.to_tensor(x),
               sequence_length=paddle_tpu_torch.to_tensor(lens))
    np.testing.assert_array_equal(y.numpy(), y2.numpy())


def test_relu_simple_rnn_kept_difference(cpu):
    """The port's ``SimpleRNN(activation="relu")`` runs relu, as upstream
    Paddle's and paddle_tpu's ``SimpleRNNCell`` do; paddle_tpu's fused
    layer runs tanh whatever the activation (its scan has no relu
    branch)."""
    jl, tl = _pair(lambda nn: nn.SimpleRNN(IN, HID, activation="relu"))
    x = np.random.RandomState(6).randn(B, T, IN).astype("float32")
    y, _ = tl(paddle_tpu_torch.to_tensor(x))
    assert float(y.min()) >= 0.0
    jcell = paddle_tpu.nn.SimpleRNNCell(IN, HID, activation="relu")
    for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        getattr(jcell, k).set_value(getattr(jl, f"{k}_l0").numpy())
    jy, _ = paddle_tpu.nn.RNN(jcell)(paddle_tpu.to_tensor(x))
    _close(y.numpy(), jy.numpy())
    jfused, _ = jl(paddle_tpu.to_tensor(x))
    assert float(jfused.numpy().min()) < 0.0       # tanh, not relu


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_cuda_fused_op_matches_the_per_step_version(cls):
    """On the card, torch's recurrent op (cuDNN) against the per-step
    version at f32 with TF32 off: outputs, states and gradients within
    2e-5 of the largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(0)
        layer = getattr(paddle_tpu_torch.nn, cls)(
            64, 96, num_layers=2, direction="bidirect", device="cuda")
        x = torch.randn(8, 35, 64, device="cuda")
        res = []
        for fused in (True, False):
            layer.fused = fused
            layer.clear_gradients()
            xt = paddle_tpu_torch.to_tensor(x, place="cuda",
                                            stop_gradient=False)
            out, fin = layer(xt)
            outs = _flat([out, fin])
            sum((o * o).sum() for o in outs).backward()
            res.append([o.detach().cpu() for o in outs]
                       + [xt.grad.cpu()]
                       + [p.grad.cpu() for p in layer.parameters()])
        for a, b in zip(*res):
            err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
            assert err < 2e-5, err
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
