"""The port's ``optimizer.lr`` held to paddle_tpu's: every schedule's
``get_lr()`` over 30 ``step()``s equals paddle_tpu's to 1e-12 (the same
float64 arithmetic), and an optimizer built on a schedule follows it
inside ``jit.TrainStep``."""
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import jit, nn, optimizer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import lr

# name -> constructor over a module (jlr or lr); the LinearWarmup case
# wraps a cosine schedule of the same module
SCHEDULES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 9, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 12, 0.001, 2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(0.1, 7, 0.001, 1.5,
                                                         cycle=True),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.3, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.2, [4, 11, 25], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.2, step_size=6, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.9 if e % 2 else 0.97),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, 13, 1e-4),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, 5, 0.0, 0.1),
    "LinearWarmup-wrapped": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, 10), 4, 0.01, 0.1),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 4, 6),
    "CyclicLR-triangular2": lambda m: m.CyclicLR(0.01, 0.1, 3,
                                                 mode="triangular2"),
    "CyclicLR-exp_range": lambda m: m.CyclicLR(0.01, 0.1, 3,
                                               mode="exp_range",
                                               exp_gamma=0.9),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 25),
}


def _trace(sched, metrics=None):
    out = [sched.get_lr()]
    for i in range(30):
        if metrics is None:
            sched.step()
        else:
            sched.step(metrics[i])
        out.append(sched.get_lr())
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    j, t = SCHEDULES[name](jlr), SCHEDULES[name](lr)
    assert isinstance(t, lr.LRScheduler)
    tj, tt = _trace(j), _trace(t)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-12)
    assert len(set(tt)) > 1
    assert t() == t.last_lr


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reduce_on_plateau_matches_jax(mode):
    """Fed the same metrics (a plateau, then noise): the same cuts."""
    r = np.random.RandomState(1)
    metrics = list(np.r_[np.linspace(1.0, 0.8, 8), np.full(10, 0.8),
                         0.8 + 0.01 * r.randn(12)])
    kw = dict(mode=mode, factor=0.5, patience=2, cooldown=1, min_lr=1e-3)
    j = jlr.ReduceOnPlateau(0.1, **kw)
    t = lr.ReduceOnPlateau(0.1, **kw)
    tj, tt = _trace(j, metrics), _trace(t, metrics)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-12)
    if mode == "min":
        assert tt[-1] < tt[0]


def test_state_dict_round_trip():
    a = lr.StepDecay(0.2, step_size=3)
    for _ in range(5):
        a.step()
    b = lr.StepDecay(0.2, step_size=3)
    b.set_state_dict(a.state_dict())
    assert b.last_epoch == 5 and b() == a()


def test_optimizer_follows_its_schedule_in_the_train_step():
    """Adam on a StepDecay inside TrainStep: each step's update is the
    one Adam takes at the schedule's lr of that call (a float-lr
    optimizer stepped with ``set_lr`` to the same values gives the same
    weights), and ``set_lr`` on a scheduled optimizer raises."""
    sched = lr.StepDecay(0.1, step_size=2, gamma=0.5)
    torch.manual_seed(0)
    x, y = torch.randn(8, 4), torch.randn(8, 2)
    nets = [nn.Linear(4, 2, device="cpu") for _ in range(2)]
    nets[1].load_state_dict(nets[0].state_dict())
    opt_s = optimizer.Adam(learning_rate=sched,
                           parameters=nets[0].parameters())
    opt_f = optimizer.Adam(learning_rate=0.1,
                           parameters=nets[1].parameters())
    steps = [jit.TrainStep(n, F.mse_loss, o)
             for n, o in zip(nets, (opt_s, opt_f))]
    seen = []
    for _ in range(5):
        seen.append(opt_s.get_lr())
        opt_f.set_lr(opt_s.get_lr())
        steps[0](x, y)
        steps[1](x, y)
        sched.step()
    assert seen == [0.1, 0.1, 0.05, 0.05, 0.025]
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError):
        opt_s.set_lr(0.3)
