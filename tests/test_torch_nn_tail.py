"""The rest of ``nn`` and ``nn.functional``, the port against paddle_tpu
on the CPU from the same seeded numpy inputs, one parametrised test a
family over ``testing.nn_tail_cases`` (which ``chip_smoke.py`` runs on
the card too): the functions (the losses, ``interpolate`` up and down in
every mode, ``grid_sample`` in each mode, padding and corner rule,
``affine_grid``, ``unfold``, ``pixel_shuffle``, ``temporal_shift``, the
in-place activations and the rest) and the layers (weights carried);
then ``weight_norm``, the random functions (by statistics), the helper
names and the kept differences.  Forward values and the gradients of
``sum(out * w)`` for a fixed random ``w`` agree within rtol 1e-5 (atol
1e-6; CTC 1e-5 and 2e-5, optax's and torch's recursions summing in
another order).

Two cases show where a naive port would differ: ``interpolate`` is held
to paddle_tpu and shown to differ from torch's own ``F.interpolate``
(which floors nearest indices and does not antialias a shrink), and
``ctc_loss``'s mean is the plain mean of the per-sequence losses, not
torch's mean over label lengths."""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.testing.nn_tail_cases import (INTERPOLATE, ctc_inputs,
                                                    function_cases,
                                                    layer_cases)

PKGS = (paddle_tpu, paddle_tpu_torch)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield
    placement.set_default(prev)


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(rs, *shape, lo=None, hi=None):
    if lo is None:
        return rs.randn(*shape).astype(np.float32)
    return rs.uniform(lo, hi, shape).astype(np.float32)


def _run(pkg, fn, inputs, grad):
    """``fn(pkg, *tensors)``'s output and the gradients of
    ``sum(out * w)`` for the inputs at the indices ``grad``."""
    ts = [pkg.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(inputs)]
    out = fn(pkg, *ts)
    res = [np.asarray(out.numpy())]
    if grad:
        w = _f32(_rs(99), *res[0].shape) if res[0].shape else np.float32(
            1.5)
        (out * pkg.to_tensor(w)).sum().backward()
        res += [np.asarray(ts[i].grad.numpy()) for i in grad]
    return res


def _both(fn, inputs, grad=(), rtol=RTOL, atol=ATOL):
    j = _run(paddle_tpu, fn, inputs, grad)
    t = _run(paddle_tpu_torch, fn, inputs, grad)
    assert t[0].shape == j[0].shape
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    return t


# -- functions ------------------------------------------------------------
def _tol(name):
    return (dict(rtol=1e-5, atol=2e-5) if "ctc" in name.lower()
            else dict(rtol=RTOL, atol=ATOL))


@pytest.mark.parametrize("case", function_cases(), ids=lambda c: c[0])
def test_functions(case):
    name, fn, inputs, grad = case
    _both(fn, inputs, grad, **_tol(name))


@pytest.mark.parametrize("name", ["nearest-down", "bilinear-down"])
def test_interpolate_is_not_torchs_resize(name):
    """torch's own resize floors nearest indices from the pixel's corner
    and does not antialias a shrink: other numbers than paddle_tpu's
    (on the way up, half-pixel bilinear is the same filter)."""
    _, shape, kw = next(c for c in INTERPOLATE if c[0] == name)
    case = next(c for c in function_cases()
                if c[0] == "interpolate-" + name)
    out = _run(paddle_tpu_torch, case[1], case[2], ())[0]
    naive = TF.interpolate(torch.from_numpy(case[2][0]), size=kw["size"],
                           mode=kw["mode"])
    assert np.abs(naive.numpy() - out).max() > 1e-2


def test_ctc_mean_is_the_plain_mean_of_the_sequences():
    out = _run(paddle_tpu_torch, lambda p, *t: p.nn.functional.ctc_loss(
        *t, reduction="mean"), ctc_inputs(), ())[0]
    logits, labels, il, ll = (torch.from_numpy(a) for a in ctc_inputs())
    logp = torch.log_softmax(logits, -1)
    per_seq = TF.ctc_loss(logp, labels, il, ll, reduction="none")
    np.testing.assert_allclose(out, per_seq.mean().numpy(), rtol=1e-5)
    torch_mean = TF.ctc_loss(logp, labels, il, ll, reduction="mean")
    assert abs(float(torch_mean) - float(out)) > 0.1


def test_grid_sample_refuses_what_paddle_tpu_refuses():
    x = paddle_tpu_torch.zeros([1, 1, 2, 2])
    g = paddle_tpu_torch.zeros([1, 1, 1, 2])
    for pkg, a, b in ((paddle_tpu_torch, x, g),
                      (paddle_tpu, paddle_tpu.zeros([1, 1, 2, 2]),
                       paddle_tpu.zeros([1, 1, 1, 2]))):
        with pytest.raises(NotImplementedError):
            pkg.nn.functional.grid_sample(a, b, mode="bicubic")
        with pytest.raises(NotImplementedError):
            pkg.nn.functional.grid_sample(a, b, padding_mode="reflection")


@pytest.mark.parametrize("name", ["elu_", "relu_", "softmax_", "tanh_"])
def test_in_place_activations_return_their_input(name):
    y = paddle_tpu_torch.to_tensor(np.ones((2, 3), np.float32)) * 1.0
    assert getattr(paddle_tpu_torch.nn.functional, name)(y) is y


# -- layers -----------------------------------------------------------------
@pytest.mark.parametrize("case", layer_cases(), ids=lambda c: c[0])
def test_layers(case):
    name, make, inputs, grad = case
    paddle_tpu.seed(11)
    jl, tl = make(paddle_tpu.nn), make(paddle_tpu_torch.nn)
    sd = {k: np.asarray(v.data) for k, v in jl.state_dict().items()}
    assert list(tl.state_dict()) == list(sd)
    if sd:
        tl.set_state_dict(state_dict_from_paddle_tpu(sd, "cpu", tl))
    res = {}
    for pkg, layer in ((paddle_tpu, jl), (paddle_tpu_torch, tl)):
        res[pkg.__name__] = _run(pkg, lambda p, *ts: layer(*ts), inputs,
                                 grad) + [np.asarray(p.grad.numpy())
                                          for _, p in sorted(
                                              layer.named_parameters())]
    for a, b in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        np.testing.assert_allclose(a, b, **_tol(name))


# -- weight_norm --------------------------------------------------------------
@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_names_shapes_and_gradients(dim):
    rs = _rs(9)
    x = _f32(rs, 3, 4)
    layers = {}
    for pkg in PKGS:
        pkg.seed(3)
        layers[pkg.__name__] = pkg.nn.Linear(4, 5)
    jl, tl = layers["paddle_tpu"], layers["paddle_tpu_torch"]
    sd = {k: np.asarray(v.data) for k, v in jl.state_dict().items()}
    tl.set_state_dict(state_dict_from_paddle_tpu(sd, "cpu", tl))
    for pkg, layer in ((paddle_tpu, jl), (paddle_tpu_torch, tl)):
        pkg.nn.weight_norm(layer, dim=dim)
    assert list(tl.state_dict()) == list(jl.state_dict()) == [
        "bias", "weight_g", "weight_v"]
    assert "weight" not in dict(tl.named_parameters())
    for k, v in jl.state_dict().items():
        assert list(tl.state_dict()[k].shape) == list(v.shape), k
    res = {}
    for pkg, layer in ((paddle_tpu, jl), (paddle_tpu_torch, tl)):
        out = _run(pkg, lambda p, a: layer(a), [x], (0,))
        grads = [np.asarray(layer._parameters[n].grad.numpy())
                 for n in ("weight_g", "weight_v", "bias")]
        pkg.nn.remove_weight_norm(layer)
        res[pkg.__name__] = out + grads + [np.asarray(layer.weight.numpy())]
    for a, b in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res["paddle_tpu_torch"][-1], sd["weight"],
                               rtol=1e-5, atol=1e-6)
    assert sorted(dict(tl.named_parameters())) == ["bias", "weight"]


def test_weight_norm_trains_g_and_v():
    paddle_tpu_torch.seed(4)
    layer = paddle_tpu_torch.nn.weight_norm(paddle_tpu_torch.nn.Linear(4, 3))
    opt = paddle_tpu_torch.optimizer.SGD(0.1, parameters=layer.parameters())
    g0 = layer.weight_g.numpy().copy()
    x = paddle_tpu_torch.to_tensor(_f32(_rs(10), 2, 4))
    layer(x).sum().backward()
    opt.step()
    assert not np.allclose(layer.weight_g.numpy(), g0)
    w = layer.weight_v.numpy()
    expected = layer.weight_g.numpy() * w / np.linalg.norm(
        w, axis=1, keepdims=True)
    layer(x)
    np.testing.assert_allclose(layer.weight.numpy(), expected, rtol=1e-6)


# -- random functions ---------------------------------------------------------
def test_channel_dropouts_drop_whole_channels():
    x = np.ones((64, 32, 3, 4), np.float32)
    for pkg in PKGS:
        pkg.seed(21)
        out = np.asarray(pkg.nn.functional.dropout2d(
            pkg.to_tensor(x), 0.25).numpy())
        per_channel = out.reshape(64, 32, -1)
        assert np.all(per_channel.min(-1) == per_channel.max(-1))
        kept = per_channel[..., 0] != 0
        assert abs(kept.mean() - 0.75) < 0.03
        np.testing.assert_allclose(per_channel[kept][:, 0], 1 / 0.75,
                                   rtol=1e-3)
    out = np.asarray(paddle_tpu_torch.nn.functional.dropout3d(
        paddle_tpu_torch.to_tensor(np.ones((16, 8, 2, 3, 4), np.float32)),
        0.5).numpy()).reshape(16, 8, -1)
    assert np.all(out.min(-1) == out.max(-1))
    out = paddle_tpu_torch.nn.Dropout2D(0.5, data_format="NHWC")(
        paddle_tpu_torch.to_tensor(np.ones((4, 3, 5, 16), np.float32)))
    per_channel = np.moveaxis(out.numpy(), -1, 1).reshape(4, 16, -1)
    assert np.all(per_channel.min(-1) == per_channel.max(-1))


def test_alpha_dropout_keeps_unit_statistics():
    """A unit normal input keeps mean 0 and variance 1; dropped values
    sit at one constant; the kept share is 1 - p, as in paddle_tpu."""
    x = _f32(_rs(11), 200, 500)
    stats = {}
    for pkg in PKGS:
        pkg.seed(22)
        out = np.asarray(pkg.nn.functional.alpha_dropout(
            pkg.to_tensor(x), 0.2).numpy())
        q = 0.8
        neg = -1.6732632423543772 * 1.0507009873554805
        A = (q + neg ** 2 * q * 0.2) ** -0.5
        dropped = np.isclose(out, A * neg - A * 0.2 * neg, atol=1e-6)
        stats[pkg.__name__] = (out.mean(), out.var(), 1 - dropped.mean())
    for mean, var, kept in stats.values():       # 4-5 sigma bounds
        assert abs(mean) < 0.015 and abs(var - 1) < 0.02
        assert abs(kept - 0.8) < 0.006


def test_gumbel_softmax_statistics():
    """Rows sum to 1; ``hard`` is the one-hot of the soft argmax with
    the soft gradient; argmax frequencies follow softmax(x)."""
    logits = np.log(np.float32([0.1, 0.2, 0.3, 0.4]))
    x = np.tile(logits, (20000, 1))
    for pkg in PKGS:
        pkg.seed(23)
        F = pkg.nn.functional
        soft = np.asarray(F.gumbel_softmax(pkg.to_tensor(x)).numpy())
        np.testing.assert_allclose(soft.sum(-1), 1.0, rtol=1e-5)
        freq = np.bincount(soft.argmax(-1), minlength=4) / len(x)
        np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.015)
    a = paddle_tpu_torch.to_tensor(x[:8], stop_gradient=False)
    hard = paddle_tpu_torch.nn.functional.gumbel_softmax(a, 0.5, hard=True)
    h = hard.numpy()
    assert np.all(h.sum(-1) == 1.0) and set(np.unique(h)) == {0.0, 1.0}
    (hard * paddle_tpu_torch.to_tensor(_f32(_rs(12), 8, 4))).sum().backward()
    assert np.abs(a.grad.numpy()).sum() > 0


# -- helpers and kept differences ---------------------------------------------
def test_helper_names():
    F = paddle_tpu_torch.nn.functional
    t = paddle_tpu_torch.to_tensor(np.arange(3, dtype=np.float32))
    assert isinstance(t, F.Tensor)
    raw = F.as_array(t)
    assert type(raw) is torch.Tensor and raw.data_ptr() == t.data_ptr()
    assert F.as_array(2.0) == 2.0
    np.testing.assert_array_equal(F.np_asarray(t), [0, 1, 2])
    np.testing.assert_array_equal(F.np_asarray([1, 2]), [1, 2])
    draw = F.stable_draw()
    assert draw.key() == draw.key()


def test_prng_keys_are_ints_kept_difference():
    """paddle_tpu's ``next_key`` gives a threefry key array; the port's
    gives an int32 seed from ``core.rng``, fresh on every call."""
    F = paddle_tpu_torch.nn.functional
    a, b = F.next_key(), F.next_key()
    assert isinstance(a, int) and a != b and -2 ** 31 <= a < 2 ** 31
    assert not isinstance(paddle_tpu.nn.functional.next_key(), int)


def test_arguments_paddle_tpu_ignores_raise_kept_difference():
    """paddle_tpu ignores ``diag_embed``'s offset and dims and the NHWC
    layout of ``pixel_shuffle`` and ``temporal_shift`` (it returns the
    default's result); the port raises on them rather than give that."""
    F = paddle_tpu_torch.nn.functional
    x = paddle_tpu_torch.zeros([2, 4, 4, 4])
    with pytest.raises(NotImplementedError):
        F.diag_embed(paddle_tpu_torch.zeros([2, 3]), offset=1)
    with pytest.raises(NotImplementedError):
        F.pixel_shuffle(x, 2, data_format="NHWC")
    with pytest.raises(NotImplementedError):
        F.temporal_shift(x, 2, data_format="NHWC")
    j = paddle_tpu.nn.functional.diag_embed(paddle_tpu.ones([3]), offset=1)
    assert list(j.shape) == [3, 3]             # the offset was ignored
    assert math.isclose(float(np.asarray(j.numpy())[0, 0]), 1.0)
