"""The port's tail optimizers and parameter averages held to paddle_tpu
on the CPU: Adamax, Adagrad, Adadelta, RMSProp (plain and centered),
Lamb, LarsMomentum, Ftrl (``lr_power`` -0.5 and general), Dpsgd,
ProximalGD, ProximalAdagrad and DecayedAdagrad, and
ExponentialMovingAverage, ModelAverage and Lookahead.

Each parity case builds the same small MLP (6 -> 8 -> 3, tanh) in both
packages from paddle_tpu's seeded weights and trains it 5 steps on the
same numpy batch, then compares every parameter:

- f32, eager ``backward``/``step``, with and without a global-norm
  clip: within ``F32_ATOL`` (Ftrl's soft threshold divides by
  ``sqrt(accumulator) / lr``, which carries f32 rounding up to 4.5e-6);
- O2 (bf16 parameters, f32 masters set by ``amp.decorate``) from the
  same fixed bf16 gradients each step, so no bf16 forward enters: the
  bf16 parameters within one bf16 rounding (``O2_RTOL``) and the f32
  masters within ``F32_ATOL``;
- Lamb and LarsMomentum inside ``jit.TrainStep`` under a
  ``GradScaler``, where the step count is a device tensor: at f32
  within ``F32_ATOL``, and under O2 within ``O2_STEP_ATOL``: there the
  bf16 forwards of XLA and ATen round differently (losses apart by up
  to 2.4e-3 from the first step), and the difference reaches the
  parameters as a few bf16 roundings at |p| < 1.

Dpsgd's noise is injected: paddle_tpu draws from threefry keys, the
port from a Philox generator of its own, so the port's ``_draw`` is
replaced by paddle_tpu's draws for the parity case; its own draws are
held by statistics.  Then the JAX package's own oracles
(``tests/test_optimizer.py``'s convergence cases and
``tests/test_optimizer_tail.py``'s numpy oracles), run on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu

F32_ATOL = 1e-5
O2_RTOL = 2 ** -7          # one bf16 rounding
O2_STEP_ATOL = 1e-2
STEPS = 5

CASES = {
    "Adamax": ("Adamax", dict(learning_rate=0.01)),
    "Adagrad": ("Adagrad", dict(learning_rate=0.05)),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0)),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    "RMSProp-centered": ("RMSProp", dict(learning_rate=0.01,
                                         centered=True)),
    "Lamb": ("Lamb", dict(learning_rate=0.01)),
    "LarsMomentum": ("LarsMomentum", dict(learning_rate=0.1)),
    "Ftrl": ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.01)),
    "Ftrl-lr_power": ("Ftrl", dict(learning_rate=0.1, l1=0.01,
                                   lr_power=-0.3)),
    "Dpsgd": ("Dpsgd", dict(learning_rate=0.05, clip=0.5, sigma=0.3,
                            batch_size=4.0, seed=3)),
    "ProximalGD": ("ProximalGD", dict(learning_rate=0.05, l1=0.01,
                                      l2=0.01)),
    "ProximalAdagrad": ("ProximalAdagrad", dict(learning_rate=0.05,
                                                l1=0.01, l2=0.01)),
    "DecayedAdagrad": ("DecayedAdagrad", dict(learning_rate=0.05)),
}


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    T.set_device("cpu")
    yield
    placement.set_default(prev)


def _mlp(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(6, 8), pkg.nn.Tanh(),
                             pkg.nn.Linear(8, 3))


def _pair(seed=1):
    """The same MLP in both packages and its initial numpy weights."""
    J.seed(seed)
    jm, tm = _mlp(J), _mlp(T)
    sd = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
    tm.set_state_dict(state_dict_from_paddle_tpu(sd, "cpu", tm))
    return jm, tm, sd


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(16, 6).astype(np.float32),
            rs.randn(16, 3).astype(np.float32))


def _jax_draws(seed, step, n):
    """paddle_tpu's Dpsgd draws: one normal per tensor, keyed on (seed,
    step, the tensor's index)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed),
                             jnp.asarray(step, jnp.int32))
    return np.array([float(jax.random.normal(
        jax.random.fold_in(key, jnp.asarray(i, jnp.int32)), (),
        jnp.float32)) for i in range(n)], np.float32)


def _opt(pkg, case, params, clip=False):
    cls, kw = CASES[case]
    kw = dict(kw)
    if clip and cls != "Dpsgd":             # Dpsgd takes no grad_clip
        kw["grad_clip"] = pkg.optimizer.ClipGradByGlobalNorm(0.5)
    opt = getattr(pkg.optimizer, cls)(parameters=params, **kw)
    if pkg is T and cls == "Dpsgd":
        opt._draw = lambda step, n, device: torch.from_numpy(
            _jax_draws(kw["seed"], step, n)).to(device)
    return opt


def _weights(m):
    return {k: np.asarray(v.numpy()).astype(np.float32)
            for k, v in m.state_dict().items()}


def _assert_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("clip", [False, True], ids=["plain", "clip"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_eager_steps_match_paddle_tpu(case, clip):
    jm, tm, sd = _pair()
    x, y = _batch()
    out = []
    for pkg, m in ((J, jm), (T, tm)):
        opt = _opt(pkg, case, m.parameters(), clip)
        for _ in range(STEPS):
            loss = ((m(pkg.to_tensor(x)) - pkg.to_tensor(y)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        out.append(_weights(m))
    _assert_close(out[1], out[0], rtol=0, atol=F32_ATOL)
    moved = max(np.abs(out[0][k] - sd[k]).max() for k in sd)
    assert moved > 100 * F32_ATOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_o2_masters_match_paddle_tpu_from_fixed_gradients(case):
    jm, tm, _ = _pair()
    rs = np.random.RandomState(5)
    grads = [[(0.3 * rs.randn(*p.shape)).astype(np.float32)
              for p in jm.parameters()] for _ in range(STEPS)]
    out = []
    for pkg, m in ((J, jm), (T, tm)):
        opt = _opt(pkg, case, m.parameters())
        m, opt = pkg.amp.decorate(m, opt, level="O2", dtype="bfloat16")
        params = list(m.parameters())
        for gs in grads:
            for p, g in zip(params, gs):
                p.grad = pkg.to_tensor(g).astype("bfloat16")
            opt.step()
            opt.clear_grad()
        slots = (opt._slots if pkg is J else opt._states)
        masters = [np.asarray(slots[id(p)]["master"]) if pkg is J
                   else slots[id(p)]["master"].numpy() for p in params]
        assert all(mm.dtype == np.float32 for mm in masters)
        out.append((_weights(m), masters,
                    [str(p.dtype).endswith("bfloat16") for p in params]))
    assert all(out[0][2]) and all(out[1][2])
    _assert_close(out[1][0], out[0][0], rtol=O2_RTOL, atol=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("o2", [False, True], ids=["f32", "O2"])
@pytest.mark.parametrize("case", ["Lamb", "LarsMomentum"])
def test_lamb_and_lars_in_train_step_under_a_scaler(case, o2):
    jm, tm, _ = _pair()
    x, y = _batch()
    out = []
    for pkg, m in ((J, jm), (T, tm)):
        opt = _opt(pkg, case, m.parameters(), clip=True)
        if o2:
            m, opt = pkg.amp.decorate(m, opt, level="O2", dtype="bfloat16")
        scaler = pkg.amp.GradScaler(init_loss_scaling=1024.0)

        def loss_fn(o, lab):
            return ((o.astype("float32") - lab) ** 2).mean()
        if pkg is J:
            step = JaxTrainStep(m, loss_fn, opt, scaler=scaler)
            xs = jnp.asarray(x, jnp.bfloat16 if o2 else jnp.float32)
            losses = [float(step(xs, jnp.asarray(y))) for _ in range(STEPS)]
        else:
            step = T.jit.TrainStep(m, loss_fn, opt, scaler=scaler)
            xs = torch.from_numpy(x).to(torch.bfloat16 if o2
                                        else torch.float32)
            losses = [float(step(xs, torch.from_numpy(y)))
                      for _ in range(STEPS)]
            assert isinstance(step._scaler_state["step"], torch.Tensor)
            assert int(step._scaler_state["step"]) == STEPS
        out.append((_weights(m), losses))
    tol = O2_STEP_ATOL if o2 else F32_ATOL
    _assert_close(out[1][0], out[0][0], rtol=0, atol=tol)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=0,
                               atol=5e-3 if o2 else 1e-5)
    if case == "Lamb":
        assert torch.isfinite(opt.trust_ratios).all()
        assert (opt.trust_ratios > 0).all()


# -- the JAX package's choices, each with its test --------------------------
def test_lamb_keeps_exclude_fn_and_never_calls_it():
    calls = []
    w = T.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    opt = T.optimizer.Lamb(learning_rate=0.1, parameters=[w],
                           exclude_from_weight_decay_fn=lambda n:
                           calls.append(n) or True)
    (w * w).sum().backward()
    opt.step()
    assert opt._exclude_fn is not None and calls == []


@pytest.mark.parametrize("cls", ["Lamb", "LarsMomentum", "Dpsgd"])
def test_optimizers_without_weight_decay_refuse_it(cls):
    w = T.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    with pytest.raises(TypeError):
        getattr(T.optimizer, cls)(parameters=[w], weight_decay=0.1)
    with pytest.raises(TypeError):
        getattr(J.optimizer, cls)(parameters=[J.to_tensor(
            np.ones(3, np.float32))], weight_decay=0.1)


def test_lamb_trust_ratio_is_one_where_a_norm_is_zero():
    w = T.to_tensor(np.zeros(3, np.float32), stop_gradient=False)
    v = T.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    opt = T.optimizer.Lamb(learning_rate=0.1, lamb_weight_decay=0.0,
                           parameters=[w, v])
    (w.sum() + (v * v).sum()).backward()
    opt.step()
    r = opt.trust_ratios.numpy()
    # ||v|| / ||r|| with r = m^ / (sqrt(v^) + eps) ~ 1 a coordinate; the
    # f32 bias corrections (1 - 0.999 is 1.3e-5 off in f32) move it
    assert r[0] == 1.0 and r[1] == pytest.approx(1.0, rel=2e-5)


def _manual(opt_cls, w0, grad, steps=1, **kw):
    """A fixed external gradient each step: the update rule alone."""
    w = T.to_tensor(w0.copy(), stop_gradient=False)
    opt = opt_cls(parameters=[w], **kw)
    outs = []
    for _ in range(steps):
        w.grad = T.to_tensor(grad.copy())
        opt.step()
        opt.clear_grad()
        outs.append(w.detach().numpy().copy())
    return outs


def test_proximal_adagrad_takes_a_zero_step_where_the_accumulator_is_zero():
    w0 = np.array([1.0, 2.0], np.float32)
    g = np.array([0.5, 0.0], np.float32)
    got = _manual(T.optimizer.ProximalAdagrad, w0, g, learning_rate=0.1)[0]
    want = _manual_jax(J.optimizer.ProximalAdagrad, w0, g,
                       learning_rate=0.1)[0]
    assert np.isfinite(got).all() and got[1] == w0[1]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _manual_jax(opt_cls, w0, grad, steps=1, **kw):
    w = J.to_tensor(w0.copy(), stop_gradient=False)
    opt = opt_cls(parameters=[w], **kw)
    outs = []
    for _ in range(steps):
        w.grad = J.to_tensor(grad.copy())
        opt.step()
        opt.clear_grad()
        outs.append(np.asarray(w.data).copy())
    return outs


def test_dpsgd_clips_the_whole_gradient_and_shares_one_draw_a_tensor():
    w0 = np.array([1.0, 2.0, 2.0], np.float32)
    g = np.array([3.0, 4.0, 0.0], np.float32)       # ||g|| = 5
    lr, clip, bs = 0.1, 1.0, 8.0
    got = _manual(T.optimizer.Dpsgd, w0, g, learning_rate=lr, clip=clip,
                  batch_size=bs, sigma=0.0)[0]
    np.testing.assert_allclose(got, w0 - lr * g / 5.0, rtol=1e-6)
    g2 = np.array([0.1, 0.0, 0.0], np.float32)      # under the clip
    got2 = _manual(T.optimizer.Dpsgd, w0, g2, learning_rate=lr, clip=clip,
                   batch_size=bs, sigma=0.0)[0]
    np.testing.assert_allclose(got2, w0 - lr * g2, rtol=1e-6)
    a = _manual(T.optimizer.Dpsgd, w0, g2, steps=2, learning_rate=lr,
                clip=clip, batch_size=bs, sigma=2.0, seed=7)
    b = _manual(T.optimizer.Dpsgd, w0, g2, steps=2, learning_rate=lr,
                clip=clip, batch_size=bs, sigma=2.0, seed=7)
    np.testing.assert_array_equal(a[1], b[1])       # the seed decides
    noise0 = (a[0] - (w0 - lr * g2)) * bs / lr
    assert np.allclose(noise0, noise0[0], atol=1e-5)   # one draw a tensor
    noise1 = (a[1] - (a[0] - lr * g2)) * bs / lr
    assert not np.allclose(noise0[0], noise1[0])    # fresh each step


def test_dpsgd_draws_are_independent_per_tensor_and_standard_normal():
    """Statistics of the port's own draws: 64 tensors x 40 steps of
    sigma 1, batch 1, lr 1 from zero gradients: the per-step noise of
    each tensor has mean ~0 and deviation ~1, and two tensors' draws
    are uncorrelated."""
    ps = [T.to_tensor(np.zeros(2, np.float32), stop_gradient=False)
          for _ in range(64)]
    opt = T.optimizer.Dpsgd(learning_rate=1.0, clip=100.0, batch_size=1.0,
                            sigma=1.0, seed=5, parameters=ps)
    draws = []
    for _ in range(40):
        before = np.array([p.detach().numpy()[0] for p in ps])
        for p in ps:
            p.grad = T.to_tensor(np.zeros(2, np.float32))
        opt.step()
        after = np.array([p.detach().numpy() for p in ps])
        assert np.allclose(after[:, 0], after[:, 1])
        draws.append(before - after[:, 0])
    d = np.array(draws)                              # [steps, tensors]
    assert abs(d.mean()) < 0.1 and abs(d.std() - 1.0) < 0.1
    corr = np.corrcoef(d.T)
    off = corr[~np.eye(64, dtype=bool)]
    assert np.abs(off).mean() < 0.2


# -- tests/test_optimizer.py:30-47 (convergence) on the port ---------------
@pytest.mark.parametrize("cls,kw", [
    ("RMSProp", dict(learning_rate=0.05)),
    ("Adagrad", dict(learning_rate=0.3)),
    ("Adadelta", dict(learning_rate=5.0)),
    ("Adamax", dict(learning_rate=0.1)),
    ("Lamb", dict(learning_rate=0.03, lamb_weight_decay=0.0)),
    ("LarsMomentum", dict(learning_rate=0.3, lars_weight_decay=0.0,
                          lars_coeff=0.01)),
])
def test_optimizer_converges(cls, kw):
    rs = np.random.RandomState(42)
    X = rs.randn(32, 4).astype(np.float32)
    Y = X @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    T.seed(42)
    net = T.nn.Linear(4, 1, bias_attr=False)
    opt = getattr(T.optimizer, cls)(parameters=net.parameters(), **kw)
    x, y = T.to_tensor(X), T.to_tensor(Y)
    losses = []
    for _ in range(300):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])


# -- tests/test_optimizer_tail.py's numpy oracles on the port --------------
def test_ftrl_matches_numpy_oracle():
    w0 = np.array([0.5, -0.8, 0.02, 1.5], np.float32)
    g = np.array([0.3, -0.2, 0.01, 0.4], np.float32)
    lr, l1, l2 = 0.1, 0.05, 0.02
    got = _manual(T.optimizer.Ftrl, w0, g, steps=3, learning_rate=lr,
                  l1=l1, l2=l2)
    p = w0.astype(np.float64)
    sq = np.zeros_like(p)
    lin = np.zeros_like(p)
    for t in range(3):
        new_sq = sq + g * g
        lin = lin + g - ((np.sqrt(new_sq) - np.sqrt(sq)) / lr) * p
        x = l1 * np.sign(lin) - lin
        y = np.sqrt(new_sq) / lr + 2 * l2
        p = np.where(np.abs(lin) > l1, x / y, 0.0)
        sq = new_sq
        np.testing.assert_allclose(got[t], p, rtol=2e-5, atol=1e-7)


def test_ftrl_general_lr_power():
    w0 = np.array([0.4, -0.6], np.float32)
    g = np.array([0.2, -0.1], np.float32)
    lr, l1, l2, lp = 0.05, 0.01, 0.0, -0.3
    got = _manual(T.optimizer.Ftrl, w0, g, learning_rate=lr, l1=l1, l2=l2,
                  lr_power=lp)[0]
    new_sq = g.astype(np.float64) ** 2
    lin = g - ((new_sq ** -lp) / lr) * w0
    x = l1 * np.sign(lin) - lin
    y = new_sq ** -lp / lr + 2 * l2
    np.testing.assert_allclose(got, np.where(np.abs(lin) > l1, x / y, 0.0),
                               rtol=2e-5)


def test_proximal_gd_soft_threshold_and_l2_shrink():
    w0 = np.array([0.5, -0.5, 0.01, -0.01], np.float32)
    g = np.array([0.1, -0.1, 0.0, 0.0], np.float32)
    lr, l1, l2 = 0.2, 0.1, 0.05
    got = _manual(T.optimizer.ProximalGD, w0, g, learning_rate=lr, l1=l1,
                  l2=l2)[0]
    prox = w0 - lr * g
    np.testing.assert_allclose(
        got, np.sign(prox) * np.maximum(np.abs(prox) - lr * l1, 0.0)
        / (1.0 + lr * l2), rtol=1e-6)
    got2 = _manual(T.optimizer.ProximalGD, w0, g, learning_rate=lr, l1=0.0,
                   l2=l2)[0]
    np.testing.assert_allclose(got2, (w0 - lr * g) / (1 + lr * l2),
                               rtol=1e-6)


def test_proximal_adagrad_matches_oracle():
    w0 = np.array([1.0, -2.0, 0.3], np.float32)
    g = np.array([0.5, -0.4, 0.2], np.float32)
    lr, l1, l2 = 0.1, 0.02, 0.01
    got = _manual(T.optimizer.ProximalAdagrad, w0, g, steps=2,
                  learning_rate=lr, l1=l1, l2=l2)
    p = w0.astype(np.float64)
    mom = np.zeros_like(p)
    for t in range(2):
        mom = mom + g * g
        prox = p - lr * g / np.sqrt(mom)
        p = (np.sign(prox) * np.maximum(np.abs(prox) - lr * l1, 0.0)
             / (1.0 + lr * l2))
        np.testing.assert_allclose(got[t], p, rtol=2e-5)


def test_decayed_adagrad_matches_oracle():
    w0 = np.array([1.0, -1.0], np.float32)
    g = np.array([0.5, 0.25], np.float32)
    lr, decay, eps = 0.1, 0.9, 1e-6
    got = _manual(T.optimizer.DecayedAdagrad, w0, g, steps=3,
                  learning_rate=lr, decay=decay, epsilon=eps)
    p = w0.astype(np.float64)
    mom = np.zeros_like(p)
    for t in range(3):
        mom = decay * mom + (1 - decay) * g * g
        p = p - lr * g / (np.sqrt(mom) + eps)
        np.testing.assert_allclose(got[t], p, rtol=2e-5)


@pytest.mark.parametrize("cls,kw", [
    ("Ftrl", dict(learning_rate=0.5, l1=0.001, l2=0.001)),
    ("ProximalGD", dict(learning_rate=0.1, l1=0.001, l2=0.001)),
    ("ProximalAdagrad", dict(learning_rate=0.5, l1=0.0, l2=0.001)),
    ("DecayedAdagrad", dict(learning_rate=0.5, decay=0.9)),
    ("Dpsgd", dict(learning_rate=0.05, clip=100.0, batch_size=64.0,
                   sigma=0.001)),
])
def test_converges_on_quadratic(cls, kw):
    target = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    w = T.to_tensor(np.zeros(4, np.float32), stop_gradient=False)
    opt = getattr(T.optimizer, cls)(parameters=[w], **kw)
    first = last = None
    for _ in range(60):
        loss = ((w - T.to_tensor(target)) ** 2).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        first = first if first is not None else float(loss)
        last = float(loss)
    assert last < first * 0.2, (cls, first, last)


# -- EMA, ModelAverage, Lookahead ------------------------------------------
def _sgd_trajectory(pkg, m, x, y, steps, after_step):
    opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    for _ in range(steps):
        loss = ((m(pkg.to_tensor(x)) - pkg.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        after_step()


@pytest.mark.parametrize("thres", [None, 1], ids=["constant", "ramp"])
def test_ema_trajectory_apply_and_restore(thres):
    jm, tm, _ = _pair()
    x, y = _batch()
    out = []
    for pkg, m in ((J, jm), (T, tm)):
        ema = pkg.optimizer.ExponentialMovingAverage(
            0.9, thres_steps=thres, parameters=m.parameters())
        _sgd_trajectory(pkg, m, x, y, 6, ema.update)
        trained = _weights(m)
        with ema.apply():
            shadow = _weights(m)
        assert all(np.array_equal(_weights(m)[k], trained[k])
                   for k in trained)
        sd = ema.state_dict()
        assert sd["step"] == 6
        out.append((trained, shadow))
    _assert_close(out[1][0], out[0][0], rtol=0, atol=F32_ATOL)
    _assert_close(out[1][1], out[0][1], rtol=0, atol=F32_ATOL)


def test_model_average_rotates_its_two_blocks():
    jm, tm, _ = _pair()
    x, y = _batch()
    out = []
    for pkg, m in ((J, jm), (T, tm)):
        ma = pkg.optimizer.ModelAverage(0.15, parameters=m.parameters(),
                                        min_average_window=2,
                                        max_average_window=3)
        _sgd_trajectory(pkg, m, x, y, 7, ma.step)
        assert (ma._count, ma._prev_count) == (1, 3)
        with ma.apply():
            avg = _weights(m)
        out.append(avg)
    _assert_close(out[1], out[0], rtol=0, atol=F32_ATOL)
    with pytest.raises(RuntimeError):
        T.optimizer.ModelAverage(parameters=tm.parameters()).apply()


def test_lookahead_trajectory():
    jm, tm, _ = _pair()
    x, y = _batch()
    out = []
    for pkg, m in ((J, jm), (T, tm)):
        inner = pkg.optimizer.Adam(learning_rate=0.01,
                                   parameters=m.parameters())
        opt = pkg.optimizer.Lookahead(inner, alpha=0.5, k=3)
        traj = []
        for _ in range(7):
            loss = ((m(pkg.to_tensor(x)) - pkg.to_tensor(y)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            traj.append(_weights(m))
        assert opt.get_lr() == 0.01
        out.append(traj)
    for a, b in zip(out[1], out[0]):
        _assert_close(a, b, rtol=0, atol=F32_ATOL)
    assert T.optimizer.LookaheadOptimizer is T.optimizer.Lookahead
