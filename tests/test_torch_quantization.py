"""``quantization`` held to paddle_tpu's on the CPU: the cases of
``tests/test_quantization.py`` on both packages from the same seeded
numpy weights and inputs, plus what the port must keep that those cases
do not pin.

Tolerances: fake quantisation within ``FQ_RTOL`` (the same levels;
XLA may fold the scale's division into another order, a float32 ulp);
the PTQ observers' scales, the int8 weights, their scales and the int32
accumulator of the static int8 product exactly (``torch.round`` and
``jnp.round`` both round half to even); forwards and gradients within
``ATOL``; the Predictor against the eager int8 model within the JAX
file's rtol 2e-3 / atol 1e-3.  The accuracy bounds against the float
model are the JAX file's."""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as JQ

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu

ATOL = 1e-5
FQ_RTOL = 1e-6
SIDES = {"jax": (jpaddle, jnn, JQ), "torch": (tpaddle, tnn, TQ)}


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)


def _np(t):
    return np.asarray(t.numpy())


def _jstate(layer):
    return {k: np.asarray(v.data) for k, v in layer.state_dict().items()}


def _pair(build, seed):
    """The same model in both packages, the port carrying the JAX
    model's weights."""
    jpaddle.seed(seed)
    jm, tm = build(jnn), build(tnn)
    tm.set_state_dict(state_dict_from_paddle_tpu(_jstate(jm), "cpu",
                                                 model=tm))
    return {"jax": jm, "torch": tm}


def _mlp(nn):
    return nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 8))


# -- fake-quant ops ---------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 0, 1])
def test_fake_quant_matches_paddle_tpu_and_stays_within_half_a_step(axis):
    x = np.random.RandomState(0).randn(64, 32).astype(np.float32)

    def run(P, nn, Q):
        t = P.to_tensor(x)
        if axis is None:
            return _np(Q.fake_quantize_abs_max(t, bit_length=8))
        return _np(Q.fake_channel_wise_quantize_abs_max(t, 8,
                                                        quant_axis=axis))

    got = {k: run(*v) for k, v in SIDES.items()}
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=FQ_RTOL)
    red = None if axis is None else 1 - axis
    step = np.abs(x).max(axis=red, keepdims=True) / 127
    assert np.all(np.abs(got["torch"] - x) <= step * 0.51 + 1e-7)


def test_fake_quant_ste_gradient():
    x = np.linspace(-1, 1, 16).astype(np.float32)
    for P, _, Q in SIDES.values():
        t = P.to_tensor(x, stop_gradient=False)
        Q.fake_quantize_abs_max(t).sum().backward()
        # straight-through: gradient of round is identity in the range
        np.testing.assert_allclose(_np(t.grad), np.ones(16), rtol=1e-5)


def test_rounding_is_half_to_even_on_both_packages():
    """At 2 bits (qmax 1) and abs-max 4, x / 4 is exact: the halves go
    to the even level, -2 and 2 to 0, not to -4 and 4."""
    x = np.array([-4.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0, 4.0], np.float32)
    want = np.array([-4, 0, 0, 0, 0, 0, 4, 4], np.float32)
    for P, _, Q in SIDES.values():
        got = _np(Q.fake_quantize_abs_max(P.to_tensor(x), bit_length=2))
        np.testing.assert_array_equal(got, want)
    q, _ = TQ._quantize_weight(torch.from_numpy(x[:, None]), 2, axis=1)
    assert q.flatten().tolist() == [-1, 0, 0, 0, 0, 0, 1, 1]


# -- QAT --------------------------------------------------------------------

def test_quantized_linear_dx_and_dw_match_paddle_tpu():
    """The wrapped forward and both gradients: dx through the
    fake-quantised weight (what paddle_tpu's tape captured), dw the
    straight-through gradient; the activation fake-quant is the
    moving-average one after a calibrated scale."""
    models = _pair(lambda nn: nn.Linear(12, 5), 7)
    r = np.random.RandomState(7)
    x = r.randn(6, 12).astype(np.float32)
    got = {}
    for k, (P, nn, Q) in SIDES.items():
        q = Q.QuantizedLinear(models[k])
        q.train()
        outs = []
        for scale in (0.0, 2.5):     # abs-max, then the calibrated scale
            q.act_scale.set_value(np.asarray(scale, np.float32))
            xt = P.to_tensor(x, stop_gradient=False)
            out = q(xt)
            (out * out).sum().backward()
            w = models[k].weight
            outs.append([_np(out), _np(xt.grad), _np(w.grad),
                         _np(models[k].bias.grad)])
            w.clear_gradient()
            models[k].bias.clear_gradient()
        got[k] = outs
    for t, j in zip(got["torch"], got["jax"]):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=ATOL)
    # dx is taken through w_q, not the float weight
    w = _jstate(models["jax"])["weight"]
    out, dx = got["torch"][0][:2]
    assert np.abs(dx - (2 * out) @ w.T).max() > 1e-4


def test_qat_model_trains_and_starts_as_paddle_tpu():
    """The JAX file's QAT loop (50 Adam steps) on the port; its first
    loss against paddle_tpu's forward of the same quantised model (the
    gradients are held in the dx/dw case)."""
    models = _pair(lambda nn: nn.Sequential(nn.Linear(8, 32), nn.ReLU(),
                                            nn.Linear(32, 1)), 1)
    r = np.random.RandomState(1)
    x = r.randn(64, 8).astype(np.float32)
    y = (x @ r.randn(8, 1)).astype(np.float32)
    jm = JQ.QAT(JQ.QuantConfig()).quantize(models["jax"])
    first = float(jpaddle.nn.functional.mse_loss(
        jm(jpaddle.to_tensor(x)), jpaddle.to_tensor(y)))
    m = TQ.QAT(TQ.QuantConfig()).quantize(models["torch"])
    opt = tpaddle.optimizer.Adam(learning_rate=0.01,
                                 parameters=m.parameters())
    losses = []
    for _ in range(50):
        loss = tpaddle.nn.functional.mse_loss(m(tpaddle.to_tensor(x)),
                                              tpaddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], first, rtol=1e-5)
    assert losses[-1] < losses[0] * 0.3, (losses[0], losses[-1])


def test_qat_conv_swap_matches_paddle_tpu():
    models = _pair(lambda nn: nn.Sequential(nn.Conv2D(3, 8, 3, padding=1),
                                            nn.ReLU()), 3)
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    got = {}
    for k, (P, nn, Q) in SIDES.items():
        Q.QAT().quantize(models[k])
        assert isinstance(models[k][0], Q.QuantizedConv2D)
        got[k] = _np(models[k](P.to_tensor(x)))
    assert got["torch"].shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5,
                               atol=ATOL)


# -- PTQ and int8 deployment -----------------------------------------------

def _calibrated(models, x, convert=True):
    for k, (P, nn, Q) in SIDES.items():
        Q.PTQ().quantize(models[k])
        for _ in range(4):
            models[k](P.to_tensor(x))
        Q.PTQ.convert(models[k])
        if convert:
            Q.convert_to_int8(models[k])
    return models


def test_ptq_calibrate_convert_matches_paddle_tpu_and_the_float_model():
    models = _pair(lambda nn: nn.Sequential(nn.Linear(16, 32), nn.ReLU(),
                                            nn.Linear(32, 4)), 2)
    x = np.random.RandomState(2).randn(32, 16).astype(np.float32)
    ref = _np(models["torch"](tpaddle.to_tensor(x)))
    _calibrated(models, x, convert=False)
    scales = {k: [float(w.act_scale.numpy()) for w in m.sublayers()
                  if hasattr(w, "observe")] for k, m in models.items()}
    assert scales["torch"] == scales["jax"] and len(scales["torch"]) == 2
    got = {k: _np(m(SIDES[k][0].to_tensor(x))) for k, m in models.items()}
    np.testing.assert_allclose(got["torch"], got["jax"], atol=ATOL)
    denom = np.abs(ref).max()
    assert np.abs(got["torch"] - ref).max() / denom < 0.1


def test_convert_to_int8_accuracy_and_serving(tmp_path):
    """PTQ -> convert_to_int8 -> jit.save -> Predictor: the int8 model
    equals paddle_tpu's, stays close to the float model, keeps only int8
    weights in its state dict, and the Predictor serves what it
    computes eagerly."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.jit import InputSpec
    models = _pair(_mlp, 50)
    x = np.random.RandomState(50).randn(8, 16).astype(np.float32)
    ref = _np(models["torch"](tpaddle.to_tensor(x)))
    _calibrated(models, x)
    net = models["torch"]
    assert any(isinstance(m, TQ.Int8Linear) for m in net.sublayers())
    got = _np(net(tpaddle.to_tensor(x)))
    np.testing.assert_allclose(
        got, _np(models["jax"](jpaddle.to_tensor(x))), atol=ATOL)
    assert np.abs(got - ref).max() < 0.12 * np.abs(ref).max() + 0.05

    sd = net.state_dict()
    qw = [v for k, v in sd.items() if k.endswith("qweight")]
    assert qw and all(v.dtype == torch.int8 for v in qw)
    assert not any(k.endswith(".weight") for k in sd)
    jsd = _jstate(models["jax"])
    assert sorted(jsd) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), jsd[k], err_msg=k)

    pfx = os.path.join(str(tmp_path), "int8")
    jit.save(net, pfx, input_spec=[InputSpec([None, 16], "float32")])
    pred = inference.create_predictor(inference.Config(pfx))
    out = np.asarray(pred.run([x])[0])
    np.testing.assert_allclose(out, got, rtol=2e-3, atol=1e-3)


def test_int8_static_accumulator_is_paddle_tpus_bitwise():
    """The static path's int8 activations and int32 accumulator equal
    paddle_tpu's bit for bit (``lax.dot_general`` to int32 against
    ``torch._int_mm``), and both paths track the float result within
    the JAX file's bounds."""
    import jax
    import jax.numpy as jnp
    models = _pair(lambda nn: nn.Linear(8, 4), 51)
    x = np.random.RandomState(51).randn(4, 8).astype(np.float32)
    ref = _np(models["torch"](tpaddle.to_tensor(x)))
    amax = float(np.abs(x).max())
    j8 = JQ.Int8Linear(models["jax"], act_scale=amax)
    t8 = TQ.Int8Linear(models["torch"], act_scale=amax)
    assert j8._static_act and t8._static_act
    np.testing.assert_array_equal(t8.qweight.numpy(),
                                  np.asarray(j8.qweight.data))
    np.testing.assert_array_equal(t8.w_scale.numpy(),
                                  np.asarray(j8.w_scale.data))
    qmax = 127.0
    ja = jnp.round(jnp.clip(jnp.asarray(x) / j8.act_scale.data * qmax,
                            -qmax, qmax)).astype(jnp.int8)
    jacc = jax.lax.dot_general(ja, j8.qweight.data, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    xt = torch.from_numpy(x)
    ta = torch.round(torch.clamp(xt / t8.act_scale * qmax, -qmax, qmax)
                     ).to(torch.int8)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    tacc = TQ.int8_matmul(ta, t8.qweight)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    got = _np(t8(tpaddle.to_tensor(x)))
    np.testing.assert_allclose(got, _np(j8(jpaddle.to_tensor(x))),
                               atol=ATOL)
    assert np.abs(got - ref).max() < 0.1 * np.abs(ref).max() + 0.05
    # weight-only dynamic path too
    d8 = TQ.Int8Linear(models["torch"], act_scale=0.0)
    assert not d8._static_act
    got_d = _np(d8(tpaddle.to_tensor(x)))
    np.testing.assert_allclose(got_d, _np(JQ.Int8Linear(
        models["jax"], act_scale=0.0)(jpaddle.to_tensor(x))), atol=ATOL)
    assert np.abs(got_d - ref).max() < 0.05 * np.abs(ref).max() + 0.02


def test_int8_conv_matches_paddle_tpu():
    models = _pair(lambda nn: nn.Sequential(
        nn.Conv2D(3, 6, 3, stride=2, padding=1), nn.ReLU()), 9)
    x = np.random.RandomState(9).randn(2, 3, 8, 8).astype(np.float32)
    _calibrated(models, x)
    assert isinstance(models["torch"][0], TQ.Int8Conv2D)
    got = {k: _np(m(SIDES[k][0].to_tensor(x))) for k, m in models.items()}
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5,
                               atol=ATOL)
    sd = models["torch"].state_dict()
    assert sorted(sd) == sorted(_jstate(models["jax"]))
    assert sd["0.qweight"].dtype == torch.int8


def test_a_model_quantised_by_paddle_tpu_loads_through_the_carrier():
    """paddle_tpu's PTQ + convert_to_int8 output, carried by
    ``state_dict_from_paddle_tpu`` into a port model quantised the same
    way from other weights, computes what paddle_tpu's does; and so does
    a QAT wrapper's state (``_inner.weight``, ``act_scale``)."""
    x = np.random.RandomState(12).randn(8, 16).astype(np.float32)
    jpaddle.seed(12)
    jm = _calibrated({"jax": _mlp(jnn), "torch": _mlp(tnn)}, x)
    tm = jm["torch"]
    tm.set_state_dict(state_dict_from_paddle_tpu(_jstate(jm["jax"]), "cpu",
                                                 model=tm))
    assert tm[0].qweight.dtype == torch.int8
    np.testing.assert_allclose(_np(tm(tpaddle.to_tensor(x))),
                               _np(jm["jax"](jpaddle.to_tensor(x))),
                               atol=ATOL)
    jq, tq = JQ.QAT().quantize(_mlp(jnn)), TQ.QAT().quantize(_mlp(tnn))
    jq[0].act_scale.set_value(np.asarray(1.5, np.float32))
    state = _jstate(jq)
    assert "0._inner.weight" in state and "0.act_scale" in state
    tq.set_state_dict(state_dict_from_paddle_tpu(state, "cpu", model=tq))
    np.testing.assert_allclose(_np(tq(tpaddle.to_tensor(x))),
                               _np(jq(jpaddle.to_tensor(x))), atol=ATOL)


@pytest.mark.cuda
def test_int8_matmul_pads_products_outside_int_mm_limits_on_the_card():
    """On CUDA, a product with 16 rows or fewer, or K or N off a
    multiple of 8 (BERT's 30522-wide head), is zero-padded and sliced
    back: the same int32 result as the CPU's, computed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator().manual_seed(0)
    for m, k, n in ((1, 768, 768), (16, 768, 30522), (40, 30, 13)):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        got = TQ.int8_matmul(a.cuda(), b.cuda())
        assert got.device.type == "cuda" and got.shape == (m, n)
        assert torch.equal(got.cpu(), torch._int_mm(a, b))
