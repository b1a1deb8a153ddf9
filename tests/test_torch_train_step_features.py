"""The port's ``jit.TrainStep`` features held to paddle_tpu's
(``tests/test_trainstep_features.py``'s cases): loss scaling in the
step, gradient accumulation, both together, the scaler's state read
from the step, the divisibility error, and ``amp_level``.

Each case runs the JAX ``TrainStep`` and the port's on the same
``Linear(4, 2)`` weights and numpy inputs, with Adam (the optimizer
both packages have) where the JAX tests take SGD or Momentum."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu_torch import amp, jit, nn, optimizer
from paddle_tpu_torch.nn import functional as F


def _problem(seed, rows=8):
    r = np.random.RandomState(seed)
    x = r.randn(rows, 4).astype(np.float32)
    y = r.randn(rows, 2).astype(np.float32)
    paddle.seed(seed)
    jnet = jnn.Linear(4, 2)
    net = nn.Linear(4, 2, device="cpu")
    with torch.no_grad():
        net.weight.copy_(torch.tensor(np.asarray(jnet.weight.numpy())))
        net.bias.copy_(torch.tensor(np.asarray(jnet.bias.numpy())))
    return jnet, net, x, y


def _steps(jnet, net, lr, batches, loss=("mse", "mse"), **kw):
    """Both steps over ``batches`` [(x, y)]: (jax losses, port losses,
    jax step, port step)."""
    jkw = {k: v[0] for k, v in kw.items()}
    tkw = {k: v[1] for k, v in kw.items()}
    jl = {"mse": lambda o, l: JF.mse_loss(o, l),
          "inf": lambda o, l: JF.mse_loss(o, l) * float("inf")}[loss[0]]
    tl = {"mse": F.mse_loss,
          "inf": lambda o, l: F.mse_loss(o, l) * float("inf")}[loss[1]]
    js = JaxTrainStep(jnet, jl, jopt.Adam(learning_rate=lr,
                                          parameters=jnet.parameters()),
                      **jkw)
    ts = jit.TrainStep(net, tl, optimizer.Adam(learning_rate=lr,
                                               parameters=net.parameters()),
                       **tkw)
    jls = [float(js(jnp.asarray(x), jnp.asarray(y))) for x, y in batches]
    tls = [float(ts(torch.from_numpy(x), torch.from_numpy(y)))
           for x, y in batches]
    return jls, tls, js, ts


def _same_weights(jnet, net, lr):
    """Within 1e-4 of one Adam step (lr): the JAX step takes Adam's bias
    corrections ``1 - beta ** t`` in f32 on the device, the port in f64
    (0.999 is 1.3e-8 off in f32, so ``1 - 0.999`` is 1.3e-5 off), and
    each step moves a weight by about lr times the corrections' ratio."""
    for a, b in ((net.weight, jnet.weight), (net.bias, jnet.bias)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(
            b.numpy()), rtol=0, atol=1e-4 * lr)


def _scalers(**kw):
    return (jamp.GradScaler(**kw), amp.GradScaler(**kw))


def test_ingraph_loss_scaling_trains():
    """30 steps with a 256 loss scale: losses rtol 1e-5 against JAX,
    halved at least, and no overflow moved the scale."""
    jnet, net, x, y = _problem(0)
    jl, tl, js, ts = _steps(jnet, net, 0.1, [(x, y)] * 30,
                            scaler=_scalers(init_loss_scaling=256.0))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0] * 0.5
    assert ts.loss_scale == js.loss_scale == 256.0


def test_ingraph_scaling_skips_update_on_overflow():
    jnet, net, x, y = _problem(0)
    w0 = net.weight.detach().clone()
    jl, tl, js, ts = _steps(jnet, net, 0.1, [(x, y)], loss=("inf", "inf"),
                            scaler=_scalers(init_loss_scaling=64.0,
                                            decr_every_n_nan_or_inf=1))
    assert torch.equal(net.weight.detach(), w0)          # skipped
    assert ts.loss_scale == js.loss_scale == 32.0        # halved
    ts(torch.from_numpy(x), torch.from_numpy(y))
    assert ts.loss_scale == 16.0


def test_overflow_step_leaves_adams_count_alone():
    """An overflowing batch between good ones: it updates nothing, Adam's
    bias correction counts only the applied steps, and the weights after
    the sequence equal JAX's (within 1e-4 of one Adam step)."""
    jnet, net, x, y = _problem(1)
    bad = y.copy()
    bad[0, 0] = np.inf
    batches = [(x, y), (x, bad), (x, y), (x, y)]
    jl, tl, js, ts = _steps(jnet, net, 0.05, batches,
                            scaler=_scalers(init_loss_scaling=8.0))
    assert int(ts._scaler_state["step"]) == 3
    assert bool(ts._scaler_state["found_inf"]) is False
    assert ts.loss_scale == js.loss_scale == 4.0
    _same_weights(jnet, net, 0.05)


def test_ingraph_scaling_grows_scale():
    jnet, net, x, y = _problem(0)
    _, _, js, ts = _steps(jnet, net, 0.01, [(x, y)] * 3,
                          scaler=_scalers(init_loss_scaling=2.0,
                                          incr_every_n_steps=3))
    assert ts.loss_scale == js.loss_scale == 4.0


def test_gradient_accumulation_matches_full_batch():
    """K=2 at f32: the mean of the microbatch losses and gradients is the
    full batch's, so 3 steps match the full-batch step (rtol 1e-6) and
    JAX's K=2 step (losses rtol 1e-5, weights within 1e-4 of one Adam
    step)."""
    jnet, net, x, y = _problem(3)
    init = {k: v.clone() for k, v in net.state_dict().items()}
    full = jit.TrainStep(net, F.mse_loss, optimizer.Adam(
        learning_rate=0.05, parameters=net.parameters()))
    fl = [float(full(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    w_full = net.weight.detach().clone()
    net.load_state_dict(init)
    jl, tl, _, _ = _steps(jnet, net, 0.05, [(x, y)] * 3,
                          accumulate_steps=(2, 2))
    np.testing.assert_allclose(tl, fl, rtol=1e-6)
    np.testing.assert_allclose(net.weight.detach().numpy(), w_full.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _same_weights(jnet, net, 0.05)


def test_accumulation_with_scaler():
    jnet, net, x, y = _problem(4)
    jl, tl, js, ts = _steps(jnet, net, 0.1, [(x, y)] * 20,
                            scaler=_scalers(init_loss_scaling=128.0),
                            accumulate_steps=(2, 2))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0] * 0.7
    assert ts.loss_scale == js.loss_scale


def test_scaler_state_dict_reflects_ingraph_state():
    jnet, net, x, y = _problem(7)
    jsc, sc = _scalers(init_loss_scaling=64.0, decr_every_n_nan_or_inf=1)
    _, _, js, ts = _steps(jnet, net, 0.1, [(x, y)], loss=("inf", "inf"),
                          scaler=(jsc, sc))
    assert sc.state_dict()["scale"] == jsc.state_dict()["scale"] == 32.0
    for s in (jsc, sc):
        s.load_state_dict({"scale": 8.0, "good_steps": 0, "bad_steps": 0})
    js(jnp.asarray(x), jnp.asarray(y))
    ts(torch.from_numpy(x), torch.from_numpy(y))
    assert ts.loss_scale == js.loss_scale == 4.0


def test_accumulate_steps_divisibility_error():
    _, net, x, y = _problem(8)
    step = jit.TrainStep(net, F.mse_loss, optimizer.Adam(
        parameters=net.parameters()), accumulate_steps=3)
    with pytest.raises(ValueError, match="accumulate_steps"):
        step(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_level_runs_the_forward_under_auto_cast(level):
    """``amp_level``: the linear runs in bf16 inside the step (the f32
    weights stay f32); losses within bf16 rounding (rtol 1e-2) of JAX's
    step under the same level, over 3 steps."""
    jnet, net, x, y = _problem(9)
    seen = []
    net.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    jl, tl, _, _ = _steps(jnet, net, 0.01, [(x, y)] * 3,
                          amp_level=(level, level))
    assert seen == [torch.bfloat16] * 3
    assert net.weight.dtype == torch.float32
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
