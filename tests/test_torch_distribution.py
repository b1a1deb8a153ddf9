"""``distribution`` held to paddle_tpu's (the distribution cases of
``tests/test_highlevel.py``, widened): ``log_prob``, ``probs``,
``entropy`` and ``kl_divergence`` of Uniform, Normal, Categorical and
Bernoulli on the same parameters and values, within ``ATOL`` (float32
formulas taken in the same order); gradients through ``log_prob``.

Kept difference: samples come from the port's Philox generator, not
paddle_tpu's threefry keys, so the same seed gives other draws; they are
held to the law by statistics, and the difference is asserted so that a
change to either stream is seen."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import distribution as JD

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import distribution as TD
from paddle_tpu_torch.core import placement

ATOL = 1e-6
SIDES = {"jax": (jpaddle, JD), "torch": (tpaddle, TD)}
R = np.random.RandomState(0)
LOC = R.randn(3).astype(np.float32)
SCALE = (R.rand(3) + 0.5).astype(np.float32)
LOGITS = R.randn(4, 5).astype(np.float32)
P = np.array([0.1, 0.5, 0.9], np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)


def _np(t):
    return np.asarray(t.numpy())


CASES = {
    "uniform": (lambda D, T: D.Uniform(0.0, 2.0),
                np.array([0.5, 1.999, 2.0, -0.1], np.float32)),
    "uniform_vec": (lambda D, T: D.Uniform(T(LOC - 1), T(LOC + SCALE)),
                    LOC.copy()),
    "normal": (lambda D, T: D.Normal(T(LOC), T(SCALE)),
               R.randn(2, 3).astype(np.float32)),
    "normal_scalar": (lambda D, T: D.Normal(0.0, 1.0),
                      np.array([0.0, 1.5], np.float32)),
    "categorical": (lambda D, T: D.Categorical(T(LOGITS)),
                    np.array([0, 4, 2, 1])),
    "bernoulli": (lambda D, T: D.Bernoulli(T(P)),
                  np.array([0.0, 1.0, 1.0], np.float32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("what", ["log_prob", "probs", "entropy"])
def test_matches_paddle_tpu(case, what):
    make, value = CASES[case]
    out = {}
    for side, (paddle, D) in SIDES.items():
        d = make(D, paddle.to_tensor)
        if what == "entropy":
            out[side] = _np(d.entropy())
        else:
            out[side] = _np(getattr(d, what)(paddle.to_tensor(value)))
    assert out["torch"].shape == out["jax"].shape
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["normal", "categorical"])
def test_kl_divergence_matches_paddle_tpu(kind):
    other = R.randn(4, 5).astype(np.float32)
    out = {}
    for side, (paddle, D) in SIDES.items():
        T = paddle.to_tensor
        if kind == "normal":
            p, q = D.Normal(T(LOC), T(SCALE)), D.Normal(0.5, 1.5)
        else:
            p, q = D.Categorical(T(LOGITS)), D.Categorical(T(other))
        out[side] = (_np(D.kl_divergence(p, q)), _np(p.kl_divergence(q)))
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_log_prob_gradient_matches_paddle_tpu():
    x0 = np.array([0.3, -1.2, 2.0], np.float32)
    grads = {}
    for side, (paddle, D) in SIDES.items():
        x = paddle.to_tensor(x0, stop_gradient=False)
        lp = D.Normal(paddle.to_tensor(LOC), paddle.to_tensor(SCALE)
                      ).log_prob(x).sum()
        (g,) = paddle.grad(lp, [x])
        grads[side] = _np(g)
    np.testing.assert_allclose(grads["torch"], grads["jax"], rtol=1e-6,
                               atol=ATOL)
    np.testing.assert_allclose(grads["torch"], -(x0 - LOC) / SCALE ** 2,
                               rtol=1e-6)


def test_samples_follow_the_law():
    tpaddle.seed(3)
    s = _np(TD.Normal(0.0, 1.0).sample([4000]))
    assert s.shape == (4000,) and abs(s.mean()) < 0.1
    assert abs(s.std() - 1) < 0.1
    u = _np(TD.Uniform(0.0, 2.0).sample([2000]))
    assert u.min() >= 0 and u.max() < 2 and abs(u.mean() - 1) < 0.1
    b = _np(TD.Bernoulli(TD._param(P)).sample([3000]))
    assert b.shape == (3000, 3)
    np.testing.assert_allclose(b.mean(0), P, atol=0.05)
    c = TD.Categorical(tpaddle.to_tensor(LOGITS)).sample([3000])
    assert tuple(c.shape) == (3000, 4) and c.dtype == tpaddle.int64
    freq = np.stack([(_np(c) == k).mean(0) for k in range(5)], -1)
    e = np.exp(LOGITS - LOGITS.max(-1, keepdims=True))
    np.testing.assert_allclose(freq, e / e.sum(-1, keepdims=True), atol=0.04)
    peaked = TD.Categorical(tpaddle.to_tensor([0.0, 0.0, 10.0]))
    assert (_np(peaked.sample([100])) == 2).mean() > 0.95
    assert float(peaked.entropy()) < 0.1


def test_samples_are_seeded_and_differ_from_paddle_tpu_kept():
    """Kept difference: the same seed draws other samples than
    paddle_tpu's (Philox against threefry); each package repeats its
    own."""
    draws = {}
    for side, (paddle, D) in SIDES.items():
        paddle.seed(5)
        a = _np(D.Normal(0.0, 1.0).sample([8]))
        paddle.seed(5)
        b = _np(D.Normal(0.0, 1.0).sample([8]))
        np.testing.assert_array_equal(a, b)
        draws[side] = a
    assert not np.allclose(draws["torch"], draws["jax"])
