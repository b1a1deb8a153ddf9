"""``vision.models`` against paddle_tpu on the CPU.

Every model is built by both packages and the port takes the JAX
model's state dict (weights and batch norm's running statistics,
``framework_io.state_dict_from_paddle_tpu`` checks names and shapes).
Inputs are seeded numpy.  Tolerance of the forwards (f32): rtol 1e-5,
atol 1e-4 (logits up to ~30 in eval).  The models are resnet18, vgg11
and the MobileNets at 32 px (resnet34 and resnet50 for their state
dicts); bench's ``bench_resnet50`` CPU config, trained by both
packages, is ``tests/test_torch_resnet50_training.py``."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.vision.models as JM
import paddle_tpu_torch
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


_BUILT = {}


def _pair(name, seed=0, fresh=False, **kwargs):
    """The model built by both packages, the port carrying the JAX
    model's initial state.  Built once a module for each ``(name, seed,
    kwargs)`` (paddle_tpu's eager initialisers compile op by op) and put
    back to that state at each call; ``fresh`` builds a pair no other
    test shares (one that casts its parameters)."""
    key = (name, seed, tuple(sorted(kwargs.items())))
    if fresh or key not in _BUILT:
        paddle_tpu.seed(seed)
        jm = getattr(JM, name)(**kwargs)
        tm = getattr(TM, name)(**kwargs)
        init = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
        if fresh:
            tm.set_state_dict(state_dict_from_paddle_tpu(init, device="cpu",
                                                         model=tm))
            return jm, tm
        _BUILT[key] = (jm, tm, init)
    jm, tm, init = _BUILT[key]
    jm.set_state_dict(init)
    tm.set_state_dict(state_dict_from_paddle_tpu(init, device="cpu",
                                                 model=tm))
    return jm, tm


def _img(n=2, hw=32, seed=0, nhwc=False):
    x = np.random.RandomState(seed).standard_normal(
        (n, 3, hw, hw)).astype(np.float32)
    return x.transpose(0, 2, 3, 1).copy() if nhwc else x


def _fwd(cpu, jm, tm, x):
    """Both forwards; paddle_tpu's eval forward through
    ``jit.to_static`` (one XLA compile of the whole forward where the
    eager one compiles op by op), its training forward eagerly."""
    jf = jm if jm.training else paddle_tpu.jit.to_static(jm)
    return (tm(cpu.to_tensor(x)).detach().numpy(),
            np.asarray(jf(paddle_tpu.to_tensor(x)).data))


@pytest.mark.parametrize("name,kwargs", [
    ("resnet18", {"num_classes": 10}),
    ("resnet34", {"num_classes": 10}),
    ("resnet50", {"num_classes": 10}),
    ("vgg11", {"batch_norm": True, "num_classes": 10}),
    ("mobilenet_v1", {"num_classes": 10}),
    ("mobilenet_v2", {"num_classes": 7}),
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
    jm, tm = _pair("resnet18", num_classes=10, fresh=True)
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
