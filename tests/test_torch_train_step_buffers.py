"""Batch norm's running statistics through ``jit.TrainStep``, against
paddle_tpu's ``TrainStep`` on the CPU.

The JAX step threads the buffers functionally (its ``new_b``): one
update a forward, in microbatch order under ``accumulate_steps``, one
under ``recompute`` (``jax.checkpoint`` gives the new buffers once), and
kept on a loss-scaled step whose gradients are not finite (only the
parameters and the optimizer state are held back).  The port's eager
step mutates the buffers in place, and must land on the same numbers.

Both packages build a small conv net from the same weights (carried from
paddle_tpu), and take the same seeded batches.  Losses, parameters and
running statistics agree within rtol 1e-5 / atol 1e-6 (f32)."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _net(paddle, block_recompute=False):
    nn = paddle.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.block = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1),
                                       nn.BatchNorm2D(4, momentum=0.8),
                                       nn.ReLU())
            self.pool = nn.AdaptiveAvgPool2D(1)
            self.bn = nn.BatchNorm1D(4)
            self.fc = nn.Linear(4, 3)

        def forward(self, x):
            if block_recompute:
                h = paddle.parallel.recompute(self.block, x)
            else:
                h = self.block(x)
            return self.fc(self.bn(self.pool(h).flatten(1)))
    return Net()


def _batch(step, n=8):
    rs = np.random.RandomState(step)
    return (rs.randn(n, 3, 6, 6).astype("float32") * 2 + 1,
            rs.randint(0, 3, (n,)).astype("int64"))


def _state(model):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor)
                          else v.data).astype("float32")
            for k, v in model.state_dict().items()}


def _run(paddle, model, steps, **step_kw):
    F = paddle.nn.functional
    opt = paddle.optimizer.Momentum(0.1, 0.9,
                                    parameters=model.parameters())
    step = paddle.jit.TrainStep(model, lambda out, y: F.cross_entropy(out, y),
                                opt, **step_kw)
    losses = []
    for i in range(steps):
        x, y = _batch(i)
        losses.append(float(step(paddle.to_tensor(x), paddle.to_tensor(y))))
    return losses, _state(model), step


def _pair():
    paddle_tpu.seed(0)
    jm = _net(paddle_tpu)
    tm = _net(paddle_tpu_torch)
    init = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
    tm.set_state_dict(state_dict_from_paddle_tpu(init, device="cpu",
                                                 model=tm))
    return jm, tm


def _assert_same(a, b):
    (la, sa), (lb, sb) = a, b
    np.testing.assert_allclose(la, lb, **TOL)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        np.testing.assert_allclose(sa[k], sb[k], err_msg=k, **TOL)


@pytest.mark.parametrize("kw", [{}, {"recompute": True},
                                {"accumulate_steps": 2},
                                {"recompute": True, "accumulate_steps": 2}],
                         ids=["plain", "recompute", "accumulate",
                              "recompute_accumulate"])
def test_running_stats_through_train_step_match(cpu, kw):
    jm, tm = _pair()
    j = _run(paddle_tpu, jm, 2, **kw)[:2]
    t = _run(cpu, tm, 2, **kw)[:2]
    assert not np.allclose(t[1]["block.1._mean"], 0.0)
    _assert_same(t, j)


def test_buffer_update_through_train_step_twin(cpu):
    """``tests/test_jit.py::test_to_static_batchnorm_buffer_update``
    through the port's compiled-step counterpart: a BatchNorm1D's
    running mean moves in a ``TrainStep``, to paddle_tpu's value."""
    paddle_tpu.seed(1)
    jbn = paddle_tpu.nn.BatchNorm1D(4)
    tbn = cpu.nn.BatchNorm1D(4)
    x = np.random.RandomState(0).randn(16, 4).astype("float32") * 3 + 1
    outs = []
    for pkg, bn in ((paddle_tpu, jbn), (cpu, tbn)):
        bn.train()
        before = np.asarray(bn._mean.numpy()).copy()
        opt = pkg.optimizer.SGD(0.1, parameters=bn.parameters())
        step = pkg.jit.TrainStep(bn, lambda out: (out * out).mean(), opt)
        step(pkg.to_tensor(x))
        after = np.asarray(bn._mean.numpy())
        assert not np.allclose(before, after)
        outs.append(after)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_skipped_scaled_step_still_moves_running_stats(cpu):
    """A GradScaler step whose gradients overflow (an infinite scale)
    keeps the parameters and the momentum, and moves the running
    statistics, as paddle_tpu's step selects only ``p`` and the
    optimizer state."""
    jm, tm = _pair()
    before = _state(tm)
    res = []
    for pkg, m in ((paddle_tpu, jm), (cpu, tm)):
        scaler = pkg.amp.GradScaler(init_loss_scaling=float("inf"))
        res.append(_run(pkg, m, 1, scaler=scaler))
    (jl, js, _), (tl, ts, tstep) = res
    assert bool(tstep._scaler_state["found_inf"])
    for k, v in ts.items():
        if k.endswith(("_mean", "_variance")):
            assert not np.array_equal(v, before[k]), k
        else:
            np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert all(float(s["velocity"].abs().sum()) == 0.0
               for s in tstep._opt_state)
    _assert_same((tl, ts), (jl, js))


def test_per_block_recompute_updates_running_stats_once(cpu):
    """``parallel.recompute`` over a block holding batch norm: the
    backward's replay leaves the running statistics as the forward left
    them, so they equal the run without recompute, bit for bit."""
    results = []
    for block_recompute in (False, True):
        cpu.seed(3)
        m = _net(cpu, block_recompute)
        if results:
            m.set_state_dict(results[0][2])
        init = {k: v.clone() for k, v in m.state_dict().items()}
        losses, state, _ = _run(cpu, m, 2)
        results.append((losses, state, init))
    (l0, s0, _), (l1, s1, _) = results
    assert l0 == l1
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
