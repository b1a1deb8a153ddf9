"""The port's ``nn.initializer`` and ``ParamAttr`` held to paddle_tpu's.

The deterministic initializers (``Constant``, ``Assign``), the fan
rules and ``Dirac``'s zero pattern are equal exactly; ``Orthogonal``
and ``Dirac``'s centre are orthogonal to f32 rounding.  The random ones
draw from other streams by design (torch generators against threefry
keys), so both packages' draws are held by mean and standard deviation
to the distribution's, within 4 sigma at 256 x 256."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layer_base import ParamAttr as JaxParamAttr
import paddle_tpu_torch as ptt
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.initializer import _fans
from paddle_tpu_torch.nn.layer_base import ParamAttr

SHAPE = (256, 256)
N = SHAPE[0] * SHAPE[1]
# std of a unit normal cut at +-2 (TruncatedNormal)
_PHI2 = math.exp(-2.0) / math.sqrt(2 * math.pi)
TRUNC_STD = math.sqrt(1 - 4 * _PHI2 / math.erf(2 / math.sqrt(2)))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("shape", [(), (7,), (5, 3), (8, 4, 3, 3),
                                   (6, 2, 5)])
def test_fan_rules_are_jaxs(shape):
    assert _fans(shape) == JI._fans(shape)


def test_constant_and_assign_equal_jaxs():
    v = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    for j, t in ((JI.Constant(0.25), I.Constant(0.25)),
                 (JI.Assign(v), I.Assign(v)),
                 (JI.Assign(v.tolist()), I.Assign(v.tolist()))):
        np.testing.assert_array_equal(_np(t((3, 4), device="cpu")),
                                      np.asarray(j((3, 4))))
    assert I.Constant(2.0)((2,), "bfloat16", "cpu").dtype == torch.bfloat16
    with pytest.raises(ValueError):
        I.Assign(v)((4, 3), device="cpu")


@pytest.mark.parametrize("shape", [(6, 6), (4, 9), (9, 4), (3, 2, 5)])
def test_orthogonal_is_orthogonal(shape):
    """Rows or columns orthonormal (whichever are fewer), to 1e-6, as
    paddle_tpu's; scaled by the gain."""
    for q in (_np(I.Orthogonal(1.5)(shape, device="cpu")),
              np.asarray(JI.Orthogonal(1.5)(shape))):
        m = q.reshape(-1, shape[-1]) / 1.5
        g = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(g, np.eye(g.shape[0]), atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 4, 4), (3, 3, 4, 6), (3, 1, 3, 2, 2)])
def test_dirac_zero_pattern_is_jaxs_and_its_centre_orthogonal(shape):
    t = _np(I.Dirac()(shape, device="cpu"))
    j = np.asarray(JI.Dirac()(shape))
    np.testing.assert_array_equal(t != 0, j != 0)
    centre = t[tuple((k - 1) // 2 for k in shape[:-2])]
    np.testing.assert_allclose(centre @ centre.T, np.eye(shape[-2]),
                               atol=1e-6)
    with pytest.raises(ValueError):
        I.Dirac()((3, 3, 5, 4), device="cpu")


def _xavier_std(gain=1.0):
    fi, fo = SHAPE
    return gain * math.sqrt(2.0 / (fi + fo))


def _kaiming_std(slope=0.0):
    return math.sqrt(2.0 / (1 + slope ** 2)) / math.sqrt(SHAPE[0])


# name -> (paddle_tpu initializer, the port's, mean, std)
RANDOM = {
    "Normal": (JI.Normal(0.5, 2.0), I.Normal(0.5, 2.0), 0.5, 2.0),
    "TruncatedNormal": (JI.TruncatedNormal(-1.0, 0.5),
                        I.TruncatedNormal(-1.0, 0.5), -1.0,
                        0.5 * TRUNC_STD),
    "Uniform": (JI.Uniform(-0.5, 1.5), I.Uniform(-0.5, 1.5), 0.5,
                2.0 / math.sqrt(12)),
    "XavierNormal": (JI.XavierNormal(gain=2.0), I.XavierNormal(gain=2.0),
                     0.0, _xavier_std(2.0)),
    "XavierUniform": (JI.XavierUniform(), I.XavierUniform(), 0.0,
                      _xavier_std()),
    "KaimingNormal": (JI.KaimingNormal(negative_slope=0.1),
                      I.KaimingNormal(negative_slope=0.1), 0.0,
                      _kaiming_std(0.1)),
    "KaimingUniform": (JI.KaimingUniform(), I.KaimingUniform(), 0.0,
                       _kaiming_std()),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_initializers_draw_the_jax_distribution(name):
    """Mean within 4 std / sqrt(n), std within 4 std / sqrt(2 n) (the
    normal's spread of a sample std; the uniform's and the cut normal's
    are narrower)."""
    j, t, mean, std = RANDOM[name]
    ptt.seed(1)
    for a in (_np(t(SHAPE, device="cpu")), np.asarray(j(SHAPE))):
        assert a.shape == SHAPE and a.dtype == np.float32
        assert abs(a.mean() - mean) <= 4 * std / math.sqrt(N)
        assert abs(a.std() - std) <= 4 * std / math.sqrt(2 * N)
    if name == "TruncatedNormal":
        assert np.abs(a - mean).max() <= 2 * 0.5 * (1 + 1e-6)


def test_draws_follow_the_seed():
    ptt.seed(4)
    a = I.Normal()((3, 3), device="cpu")
    ptt.seed(4)
    assert torch.equal(a, I.Normal()((3, 3), device="cpu"))
    assert not torch.equal(a, I.Normal()((3, 3), device="cpu"))


@pytest.mark.parametrize("form", ["none", "attr", "name", "init", "false"])
def test_param_attr_forms_are_jaxs(form):
    attr = {"none": lambda P, M: None,
            "attr": lambda P, M: P(name="w", trainable=False,
                                   need_clip=False),
            "name": lambda P, M: "emb_w",
            "init": lambda P, M: M.Constant(3.0),
            "false": lambda P, M: False}[form]
    j = JaxParamAttr._to_attr(attr(JaxParamAttr, JI))
    t = ParamAttr._to_attr(attr(ParamAttr, I))
    if form == "false":
        assert t is False and j is False
        return
    assert isinstance(t, ParamAttr)
    for k in ("name", "trainable", "need_clip", "learning_rate"):
        assert getattr(t, k) == getattr(j, k)
    assert type(t.initializer).__name__ == type(j.initializer).__name__
    with pytest.raises(TypeError):
        ParamAttr._to_attr(3)


def test_layers_take_weight_attr():
    lin = nn.Linear(4, 3, weight_attr=ParamAttr(
        name="fc_w", initializer=I.Constant(0.5), need_clip=False),
        bias_attr=I.Constant(-1.0), device="cpu")
    assert torch.equal(lin.weight, torch.full((4, 3), 0.5))
    assert torch.equal(lin.bias, torch.full((3,), -1.0))
    assert lin.weight.param_name == "fc_w" and lin.weight.need_clip is False
    assert nn.Linear(4, 3, bias_attr=False, device="cpu").bias is None
    frozen = nn.Linear(4, 3, weight_attr=ParamAttr(trainable=False),
                       device="cpu")
    assert not frozen.weight.requires_grad and frozen.bias.requires_grad
    ptt.seed(2)
    emb = nn.Embedding(300, 200, weight_attr=ParamAttr(
        initializer=I.Normal(0.0, 0.02)), device="cpu")
    w = emb.weight.detach().numpy()
    assert abs(w.std() - 0.02) <= 4 * 0.02 / math.sqrt(2 * w.size)
    ln = nn.LayerNorm(6, weight_attr=I.Constant(2.0), bias_attr=False,
                      device="cpu")
    assert torch.equal(ln.weight, torch.full((6,), 2.0)) and ln.bias is None
    from paddle_tpu_torch.optimizer import L2Decay
    decay = L2Decay(0.1)
    slow = nn.Linear(4, 3, weight_attr=ParamAttr(learning_rate=0.5,
                                                 regularizer=decay),
                     device="cpu")
    assert slow.weight.optimize_attr == {"learning_rate": 0.5}
    assert slow.weight.regularizer is decay


def test_defaults_are_unchanged():
    """Linear: XavierNormal weight from the device generator, zero bias;
    Embedding N(0, 1); LayerNorm ones and zeros."""
    ptt.seed(5)
    lin = nn.Linear(64, 32, device="cpu")
    ptt.seed(5)
    want = torch.randn(64, 32, generator=ptt.core.rng.generator("cpu")) * \
        math.sqrt(2.0 / 96)
    assert torch.equal(lin.weight, want) and not lin.bias.any()
    ln = nn.LayerNorm(8, device="cpu")
    assert torch.equal(ln.weight, torch.ones(8)) and not ln.bias.any()


def test_need_clip_false_is_left_out_of_the_global_norm():
    p = nn.Linear(2, 2, weight_attr=ParamAttr(need_clip=False),
                  device="cpu").weight
    g = torch.full((2, 2), 100.0)
    out = optimizer.ClipGradByGlobalNorm(1.0)([(p, g)])
    assert torch.equal(out[0][1], g)


def test_creation_ops_match_jaxs():
    """``paddle.zeros`` and its siblings: values and float types as
    paddle_tpu's, on the device asked for, ``*_like`` following x."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    jx = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    for name, args in (("zeros", ([2, 3],)), ("ones", ([4],)),
                       ("empty", ([2, 2],)), ("full", ([3], 1.5))):
        t = getattr(ptt, name)(*args, device="cpu")
        j = getattr(paddle, name)(*args)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
        assert str(t.dtype).endswith(str(j.dtype).split(".")[-1])
    for name, args in (("zeros_like", ()), ("ones_like", ()),
                       ("empty_like", ()), ("full_like", (2.5,))):
        t = getattr(ptt, name)(x, *args)
        j = getattr(paddle, name)(jx, *args)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    z = ptt.zeros([5], dtype=torch.bfloat16, device="cpu")
    assert z.dtype == torch.bfloat16 and not z.any()
    assert ptt.zeros([2], dtype="int64", device="cpu").dtype == torch.int64


def test_transpose_is_a_view_autograd_carries():
    w = torch.randn(3, 5, requires_grad=True)
    t = ptt.transpose(w, [1, 0])
    assert t.shape == (5, 3) and t.data_ptr() == w.data_ptr()
    j = paddle.transpose(paddle.to_tensor(w.detach().numpy()), [1, 0])
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j.numpy()))
    (t * torch.arange(15.0).reshape(5, 3)).sum().backward()
    assert torch.equal(w.grad, torch.arange(15.0).reshape(5, 3).t())
