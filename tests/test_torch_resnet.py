"""``vision.models`` against paddle_tpu on the CPU, and bench's
``bench_resnet50`` CPU config trained by both packages.

Every model is built by both packages and the port takes the JAX
model's state dict (weights and batch norm's running statistics,
``framework_io.state_dict_from_paddle_tpu`` checks names and shapes).
Inputs are seeded numpy.  Tolerances:

- forwards (f32): rtol 1e-5, atol 1e-4 (logits up to ~30 in eval);
- resnet50 over 3 Momentum steps through ``jit.TrainStep`` (bench's
  CPU config: batch 4, 64 px, f32), each step from the reference's
  state: losses rtol 1e-4; running statistics rtol 1e-3 / atol 1e-5.

The resnet50 case is the only ResNet-50 one (the JAX step compiles for
tens of seconds); the others use resnet18, vgg11 and the MobileNets at
32 px."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn.functional as JF
import paddle_tpu.vision.models as JM
import paddle_tpu_torch
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.vision.models as TM
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu

FWD = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _pair(name, seed=0, **kwargs):
    paddle_tpu.seed(seed)
    jm = getattr(JM, name)(**kwargs)
    tm = getattr(TM, name)(**kwargs)
    init = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
    tm.set_state_dict(state_dict_from_paddle_tpu(init, device="cpu",
                                                 model=tm))
    return jm, tm


def _img(n=2, hw=32, seed=0, nhwc=False):
    x = np.random.RandomState(seed).standard_normal(
        (n, 3, hw, hw)).astype(np.float32)
    return x.transpose(0, 2, 3, 1).copy() if nhwc else x


def _fwd(cpu, jm, tm, x):
    return (tm(cpu.to_tensor(x)).detach().numpy(),
            np.asarray(jm(paddle_tpu.to_tensor(x)).data))


@pytest.mark.parametrize("name,kwargs", [
    ("resnet18", {"num_classes": 10}),
    ("resnet34", {"num_classes": 10}),
    ("resnet50", {"num_classes": 10}),
    ("vgg11", {"batch_norm": True, "num_classes": 10}),
    ("mobilenet_v1", {"num_classes": 10}),
    ("mobilenet_v2", {"num_classes": 10}),
])
def test_state_dict_names_are_the_jax_packages(cpu, name, kwargs):
    jm, tm = _pair(name, **kwargs)
    jn = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    tn = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert tn == jn


@pytest.mark.parametrize("name,kwargs,train", [
    ("resnet18", {"num_classes": 10}, False),
    ("resnet18", {"num_classes": 10}, True),
    ("vgg11", {"num_classes": 10}, False),
    ("vgg11", {"batch_norm": True, "num_classes": 0}, True),
    ("mobilenet_v1", {"num_classes": 10}, False),
    ("mobilenet_v2", {"num_classes": 7}, False),
])
def test_forward_matches(cpu, name, kwargs, train):
    """Eval forwards (``tests/test_highlevel.py::test_resnet18_forward``
    and its siblings) and training-mode forwards (batch statistics,
    running statistics moved alike), at batch 4 of 32 px."""
    jm, tm = _pair(name, **kwargs)
    for m in (jm, tm):
        m.train() if train else m.eval()
    got, want = _fwd(cpu, jm, tm, _img(4))
    np.testing.assert_allclose(got, want, **FWD)
    if train:
        j = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
        for k, v in tm.state_dict().items():
            np.testing.assert_allclose(v.numpy(), j[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_nhwc_equals_nchw(cpu, train):
    """``tests/test_highlevel.py::test_resnet_data_format_parity`` on the
    port (same weights, NHWC input): equal outputs and running
    statistics, and the same as paddle_tpu's NHWC model."""
    cpu.seed(11)
    a = TM.resnet18(num_classes=7)
    b = TM.resnet18(num_classes=7, data_format="NHWC")
    b.set_state_dict(a.state_dict())
    for m in (a, b):
        m.train() if train else m.eval()
    x = _img(8)
    ya = a(cpu.to_tensor(x)).detach().numpy()
    yb = b(cpu.to_tensor(x.transpose(0, 2, 3, 1).copy())).detach().numpy()
    np.testing.assert_allclose(ya, yb, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a.layer2[0].bn1._variance.numpy(),
                               b.layer2[0].bn1._variance.numpy(),
                               rtol=1e-5, atol=1e-6)
    jm, tm = _pair("resnet18", num_classes=7, data_format="NHWC")
    for m in (jm, tm):
        m.train() if train else m.eval()
    got, want = _fwd(cpu, jm, tm, _img(8, nhwc=True))
    np.testing.assert_allclose(got, want, **FWD)


def test_o2_forward_matches_the_f32_forward(cpu):
    """``amp.decorate(level='O2')`` casts parameters and running
    statistics to bf16 in both packages; the bf16 eval forward of
    resnet18 stays within 5e-2 of the f32 one (relative to the largest
    logit) in each package, and the two packages within the same of
    each other."""
    jm, tm = _pair("resnet18", num_classes=10)
    jm.eval(), tm.eval()
    x = _img(2)
    f32, _ = _fwd(cpu, jm, tm, x)
    paddle_tpu.amp.decorate(jm, level="O2")
    cpu.amp.decorate(tm, level="O2")
    assert tm.bn1._mean.dtype == torch.bfloat16
    got = tm(cpu.to_tensor(x).astype("bfloat16")).float().detach().numpy()
    want = np.asarray(jm(paddle_tpu.to_tensor(x).astype("bfloat16"))
                      .data.astype("float32"))
    scale = np.abs(f32).max()
    assert np.abs(got - f32).max() <= 5e-2 * scale
    assert np.abs(got - want).max() <= 5e-2 * scale


def _jax_state(model, step=None):
    """A copy of a paddle_tpu model's state dict and its TrainStep's
    momentum by parameter name (None before the first step)."""
    state = {k: np.array(v.data, copy=True)
             for k, v in model.state_dict().items()}
    if step is None or step._opt_state is None:
        return state, None
    names = [k for k, _ in model.named_parameters()]
    return state, {k: np.array(s["velocity"], copy=True)
                   for k, s in zip(names, step._opt_state)}


def test_resnet50_cpu_config_trains_as_paddle_tpu(cpu):
    """bench_resnet50's CPU config (bench.py:549-571: seed 2024,
    ``resnet50``, Momentum(0.1, 0.9), ``F.cross_entropy``,
    ``TrainStep(..., n_inputs=1, donate=True)``, batch 4 of 64 px, f32)
    for 3 steps from the JAX model's weights.

    Each port step starts from the reference's state before that step
    (weights, running statistics, momentum), so each step is held on
    its own: its loss (rtol 1e-4) and the running statistics it leaves
    (rtol 1e-3 / atol 1e-5).  Run freely, the trajectory is not
    reproducible at rtol 1e-4 by any other rounding: at lr 0.1 and 16
    values a channel in layer4's batch norm, a rounding-level change
    flips ReLU signs and the paths part from step 2 on.  The reference
    itself shows it, run again with its input moved by one ulp."""
    paddle_tpu.seed(2024)
    jm = JM.resnet50()
    tm = TM.resnet50()
    rng = np.random.RandomState(0)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.randint(0, 1000, (4,)).astype(np.int64)
    init = _jax_state(jm)[0]

    def steps(pkg, F, m):
        opt = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=m.parameters())
        return pkg.jit.TrainStep(m, lambda out, lab: F.cross_entropy(
            out, lab), opt, n_inputs=1, donate=True)

    jstep, tstep = steps(paddle_tpu, JF, jm), steps(cpu, TF, tm)
    names = [k for k, _ in tm.named_parameters()]
    jx, jy = paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(y)
    tx, ty = cpu.to_tensor(x), cpu.to_tensor(y)
    free = []
    for k in range(3):
        state, vel = _jax_state(jm, jstep)
        tm.set_state_dict(state_dict_from_paddle_tpu(state, device="cpu",
                                                     model=tm))
        if vel is not None:
            tstep._opt_state = [{"velocity": torch.from_numpy(vel[n])}
                                for n in names]
        free.append(float(jstep(jx, jy)))
        np.testing.assert_allclose(float(tstep(tx, ty)), free[-1],
                                   rtol=1e-4, err_msg=f"step {k + 1}")
        after = _jax_state(jm, jstep)[0]
        stats = [n for n in after if n.endswith(("._mean", "._variance"))]
        assert len(stats) == 2 * 53
        own = tm.state_dict()
        for n in stats:
            np.testing.assert_allclose(own[n].numpy(), after[n], rtol=1e-3,
                                       atol=1e-5, err_msg=f"{n}, step {k}")
    assert abs(free[0] - np.log(1000)) < 2.0
    # the reference again, its input moved by one ulp
    jm2 = JM.resnet50()
    jm2.set_state_dict(init)
    step2 = steps(paddle_tpu, JF, jm2)
    x2 = np.nextafter(x, np.where(np.random.RandomState(5).rand(*x.shape)
                                  > 0.5, np.float32(np.inf),
                                  np.float32(-np.inf))).astype(np.float32)
    moved = [float(step2(paddle_tpu.to_tensor(x2), jy)) for _ in range(3)]
    assert abs(moved[0] - free[0]) <= 1e-4 * abs(free[0])
    assert max(abs(a - b) / abs(b) for a, b in zip(moved, free)) > 1e-2
