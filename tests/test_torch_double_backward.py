"""Second derivatives (``grad(create_graph=True)``) on the port, held to
paddle_tpu on the CPU.

- The six cases of ``tests/test_double_backward.py`` that read no JAX
  internals, each run on both packages from the same numpy inputs and
  weights: f32 within 1e-5 relative (the bf16 case within bf16's
  rounding), the dropout case by its structure (the packages draw other
  masks).
- A WGAN-GP critic trained 5 Adam steps on its gradient penalty, the
  parameters within 1e-5.
- Fault C9: a hand kernel's autograd Function (``FlashAttention``,
  ``FlashAttentionBlock``, ``FusedLinearEpilogue``) gives an exact
  second derivative on CPU tensors: the gradient penalty through
  ``nn.MultiHeadAttention`` at head dim 64 (the flash gate's) equals
  paddle_tpu's, which takes plain attention there; the direct entries
  equal differentiating their plain versions, or paddle_tpu's.  On the
  card the same call raises (``test_torch_second_order_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.ops.pallas import mha_reference as jax_mha_reference
from paddle_tpu.ops.pallas import reference_epilogue as jax_epilogue
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_epilogue as fe


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    T.set_device("cpu")
    yield
    placement.set_default(prev)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _carry(jl, tl):
    sd = {k: np.asarray(v.data) for k, v in jl.state_dict().items()}
    tl.set_state_dict(state_dict_from_paddle_tpu(sd, "cpu", tl))


# -- tests/test_double_backward.py on both packages -------------------------
def _second_derivative_scalar(pkg):
    x = pkg.to_tensor(np.array(3.0, np.float32), stop_gradient=False)
    g1, = pkg.grad(x * x * x, [x], create_graph=True)
    g2, = pkg.grad(g1, [x])
    return float(g1), float(g2)


def test_second_derivative_scalar():
    want = _second_derivative_scalar(J)
    assert want == (27.0, 18.0)
    assert _second_derivative_scalar(T) == want


def _grad_of_grad_through_network(pkg, lin, x):
    x = pkg.to_tensor(x, stop_gradient=False)
    out = pkg.nn.functional.tanh(lin(x)).sum()
    gx, = pkg.grad(out, [x], create_graph=True)
    gw, = pkg.grad((gx * gx).sum(), [lin.weight])
    return gw.numpy()


def test_grad_of_grad_through_network():
    J.seed(0)
    jl, tl = J.nn.Linear(4, 1), T.nn.Linear(4, 1)
    _carry(jl, tl)
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    want = _grad_of_grad_through_network(J, jl, x)
    got = _grad_of_grad_through_network(T, tl, x)
    assert np.abs(want).sum() > 0
    assert _rel(got, want) < 1e-5


def _critic(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(4, 16), pkg.nn.Tanh(),
                             pkg.nn.Linear(16, 1))


def _wgan_gp_steps(pkg, critic, xs):
    """The JAX test's WGAN-GP loss: -score / n + (||d score / dx|| -
    1)^2, Adam, one step a batch."""
    opt = pkg.optimizer.Adam(learning_rate=1e-3,
                             parameters=critic.parameters())
    losses = []
    for xb in xs:
        x = pkg.to_tensor(xb, stop_gradient=False)
        score = critic(x).sum()
        gx, = pkg.grad(score, [x], create_graph=True)
        norm = (gx * gx).sum(axis=1).sqrt()
        loss = -score / 16.0 + ((norm - 1.0) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, {k: np.asarray(v.numpy())
                    for k, v in critic.state_dict().items()}


def test_gradient_penalty_training_step():
    J.seed(1)
    jc, tc = _critic(J), _critic(T)
    _carry(jc, tc)
    rs = np.random.RandomState(1)
    xs = [rs.randn(16, 4).astype(np.float32) for _ in range(5)]
    jl, jw = _wgan_gp_steps(J, jc, xs)
    tl, tw = _wgan_gp_steps(T, tc, xs)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_create_graph_matches_jax_oracle():
    a = np.random.RandomState(0).randn(6).astype(np.float32)

    def f(v):
        return jnp.sum(jnp.sin(v) * v)

    expect = jax.grad(lambda v: jnp.sum(jax.grad(f)(v) ** 2))(a)
    for pkg in (J, T):
        x = pkg.to_tensor(a, stop_gradient=False)
        g1, = pkg.grad((x.sin() * x).sum(), [x], create_graph=True)
        (g1 * g1).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(expect),
                                   rtol=1e-4, atol=1e-6)


def _bf16_intermediate(pkg):
    x = pkg.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
    y = (x * x).astype("bfloat16").astype("float32").sum()
    g1, = pkg.grad(y, [x], create_graph=True)
    g2, = pkg.grad(g1.sum(), [x])
    return float(g1), float(g2)


def test_create_graph_bf16_intermediate():
    want, got = _bf16_intermediate(J), _bf16_intermediate(T)
    assert got[1] == pytest.approx(2.0, rel=1e-2)
    np.testing.assert_allclose(got, want, rtol=2 ** -7)


def _dropout_double_backward(pkg):
    pkg.seed(77)
    x = pkg.to_tensor(np.ones((64, 64), np.float32), stop_gradient=False)
    y = pkg.nn.functional.dropout(x, p=0.5, training=True)
    g = pkg.grad(y.sum(), x, create_graph=True)[0]
    h = pkg.grad((g * x).sum(), x)[0]
    return g.numpy(), h.numpy()


def test_dropout_double_backward_replays_same_mask():
    """y = x * mask: the second pass must differentiate the same mask,
    so h == g, both in {0, 2}, on both packages (whose masks differ)."""
    for pkg in (J, T):
        g, h = _dropout_double_backward(pkg)
        np.testing.assert_array_equal(h, g)
        assert set(np.unique(g)) == {0.0, 2.0}
        assert 0.4 < (g == 0).mean() < 0.6


# -- C9: second derivatives through the hand kernels' Functions ------------
def _mha_penalty(pkg, layer, x):
    t = pkg.to_tensor(x, stop_gradient=False)
    out = layer(t, t, t)
    g, = pkg.grad((out * out).sum(), [t], create_graph=True)
    (g * g).sum().backward()
    return t.grad.numpy()


@pytest.mark.parametrize("heads", [2, 8], ids=["D64-flash", "D16-plain"])
def test_gradient_penalty_through_multi_head_attention(heads):
    """E 128: 2 heads give D 64, which the flash gate takes (the port's
    ``FlashAttention`` Function), 8 heads D 16, which it refuses; eval
    mode, B 2, L 5.  Before the repair the D 64 case was off by ~93 %
    of its scale: the plain backward read ``lse`` and ``out`` as
    constants."""
    J.seed(3)
    jl, tl = J.nn.MultiHeadAttention(128, heads), T.nn.MultiHeadAttention(
        128, heads)
    jl.eval()
    tl.eval()
    _carry(jl, tl)
    x = np.random.RandomState(0).randn(2, 5, 128).astype(np.float32)
    want = _mha_penalty(J, jl, x)
    got = _mha_penalty(T, tl, x)
    assert np.abs(want).max() > 1.0
    assert _rel(got, want) < 1e-5


def _qkv(seed, B=2, L=6, H=2, D=32):
    r = np.random.RandomState(seed)
    return [r.randn(B, L, H, D).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_second_derivative_matches_paddle_tpu(causal):
    """The gradient penalty's dK through ``flash_attention`` against
    ``jax.grad`` twice over paddle_tpu's ``mha_reference``."""
    q, k, v, w = _qkv(1)

    def jax_penalty(q, k, v):
        gq = jax.grad(lambda q: jnp.sum(jax_mha_reference(
            q, k, v, causal=causal) * w))(q)
        return jnp.sum(gq * gq)

    want = jax.grad(jax_penalty, argnums=1)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    gq, = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tq,
                              create_graph=True)
    got, = torch.autograd.grad((gq * gq).sum(), tk)
    assert np.abs(np.asarray(want)).max() > 0.1
    assert _rel(got.numpy(), want) < 1e-5


def test_flash_attention_block_second_derivative_is_exact():
    """``flash_attention_block`` (out and lse both used) against
    differentiating its plain version twice."""
    q, k, v, w = _qkv(2, L=5)
    wl = np.random.RandomState(3).randn(2, 2, 5).astype(np.float32)

    def penalty(fn):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v))
        out, lse = fn(tq, tk, tv)
        first = (out * torch.from_numpy(w)).sum() + (
            lse * torch.from_numpy(wl)).sum()
        gq, gk = torch.autograd.grad(first, (tq, tk), create_graph=True)
        return torch.autograd.grad((gq * gq).sum() + (gk * gk).sum(),
                                   (tq, tk, tv))

    kw = dict(q_off=2, k_off=0, causal=True)

    def plain(tq, tk, tv):
        b = lambda t: t.transpose(1, 2)               # noqa: E731
        out, lse = fa.flash_attention_reference_fwd(b(tq), b(tk), b(tv),
                                                    **kw)
        return b(out), lse

    want = penalty(plain)
    got = penalty(lambda tq, tk, tv: fa.flash_attention_block(
        tq, tk, tv, **kw))
    for a, b in zip(got, want):
        assert b.abs().max() > 0.01
        assert _rel(a.numpy(), b.numpy()) < 1e-5


def test_fused_epilogue_second_derivative_matches_paddle_tpu():
    """bias + gelu(tanh) + residual + layer_norm: the penalty's dW
    through ``fused_linear_epilogue`` against ``jax.grad`` twice over
    paddle_tpu's ``reference_epilogue``."""
    stages = (("gelu", True), ("add",), ("layer_norm", 1e-5, True, True))
    r = np.random.RandomState(4)
    x = r.randn(6, 16).astype(np.float32)
    w = (0.3 * r.randn(16, 32)).astype(np.float32)
    b = (0.1 * r.randn(32)).astype(np.float32)
    res = r.randn(6, 32).astype(np.float32)
    gam = (1 + 0.1 * r.randn(32)).astype(np.float32)
    bet = (0.1 * r.randn(32)).astype(np.float32)
    wt = r.randn(6, 32).astype(np.float32)

    def jax_penalty(w, x):
        gx = jax.grad(lambda x: jnp.sum(jax_epilogue(
            x, w, b, stages, (res, gam, bet)) * wt))(x)
        return jnp.sum(gx * gx)

    want = jax.grad(jax_penalty)(w, x)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = fe.fused_linear_epilogue(
        tx, tw, torch.from_numpy(b), stages,
        [torch.from_numpy(a) for a in (res, gam, bet)])
    gx, = torch.autograd.grad((out * torch.from_numpy(wt)).sum(), tx,
                              create_graph=True)
    got, = torch.autograd.grad((gx * gx).sum(), tw)
    assert np.abs(np.asarray(want)).max() > 0.1
    assert _rel(got.numpy(), want) < 1e-5


def test_first_order_backward_keeps_the_kernels_path():
    """Without create_graph the backward is the kernels' (here their
    plain versions): grad mode is off inside it, and the result equals
    the plain backward's."""
    q, k, v, w = _qkv(5)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    assert all(not g.requires_grad for g in grads)
    b = lambda t: torch.from_numpy(t).transpose(1, 2)   # noqa: E731
    o, lse = fa.flash_attention_reference_fwd(b(q), b(k), b(v))
    refs = fa.flash_attention_reference_bwd(b(q), b(k), b(v), o, lse, b(w))
    for g, r in zip(grads, refs):
        np.testing.assert_array_equal(g.numpy(), r.transpose(1, 2).numpy())
