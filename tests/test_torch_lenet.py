"""bench_lenet_dygraph's training half and the eager flows of the verify
recipe, on both packages on the CPU:

- LeNet with weights carried from paddle_tpu, 3 eager steps each of
  Adam, SGD and Momentum (with L2Decay, and with parameter groups):
  losses within rtol 1e-5; parameters after SGD/Momentum within atol
  1e-5; after Adam within lr a step everywhere (a weight whose gradient
  is at rounding level may move by up to lr either way) and within 1e-5
  at the 99.9th percentile;
- the hand-written linear regression (``to_tensor``, ``matmul``,
  ``mean``, ``backward``, SGD) reaching the known w and b within 1e-3;
- ``paddle.save`` files crossing in both directions."""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.vision.models import LeNet as TLeNet


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _batch():
    rs = np.random.RandomState(0)
    return (rs.randn(64, 1, 28, 28).astype("float32"),
            rs.randint(0, 10, (64,)).astype("int64"))


def _optimizer(paddle, kind, model):
    params = model.parameters()
    if kind == "adam":
        return paddle.optimizer.Adam(1e-3, parameters=params)
    if kind == "sgd":
        return paddle.optimizer.SGD(0.01, parameters=params)
    if kind == "momentum_l2":
        return paddle.optimizer.Momentum(
            0.01, 0.9, parameters=params,
            weight_decay=paddle.regularizer.L2Decay(1e-4))
    if kind == "momentum_groups":
        return paddle.optimizer.Momentum(
            0.01, 0.9, use_nesterov=True, weight_decay=1e-4, parameters=[
                {"params": model.features.parameters()},
                {"params": model.fc.parameters()}])
    raise ValueError(kind)


def _train(paddle, F, model, kind, steps=3):
    x, y = _batch()
    opt = _optimizer(paddle, kind, model)
    xs, ys = paddle.to_tensor(x), paddle.to_tensor(y)
    losses = []
    for _ in range(steps):
        loss = F.cross_entropy(model(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    state = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    return losses, state


@pytest.mark.parametrize("kind", ["adam", "sgd", "momentum_l2",
                                  "momentum_groups"])
def test_lenet_steps_match_paddle_tpu(cpu, kind):
    paddle_tpu.seed(0)
    jm = JLeNet()
    init = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
    tm = TLeNet()
    tm.set_state_dict(state_dict_from_paddle_tpu(init, device="cpu",
                                                 model=tm))
    jl, js = _train(paddle_tpu, JF, jm, kind)
    tl, ts = _train(cpu, TF, tm, kind)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert sorted(ts) == sorted(js)
    for k in js:
        d = np.abs(ts[k] - js[k])
        if kind == "adam":
            assert d.max() <= 3 * 1e-3 * 1.01, k
            assert np.percentile(d, 99.9) <= 1e-5, k
        else:
            assert d.max() <= 1e-5, (k, d.max())


def test_lenet_parameters_and_grads_are_paddle_tensors(cpu):
    model = TLeNet()
    x, y = _batch()
    cpu.nn.functional.cross_entropy(model(cpu.to_tensor(x)),
                                    cpu.to_tensor(y)).backward()
    for name, p in model.named_parameters():
        assert isinstance(p, cpu.Parameter) and not p.stop_gradient, name
        assert isinstance(p.grad, cpu.Tensor), name
    assert [type(l).__name__ for l in model.sublayers()] == [
        "Sequential", "Conv2D", "ReLU", "MaxPool2D", "Conv2D", "ReLU",
        "MaxPool2D", "Sequential", "Linear", "Linear", "Linear"]


def _linear_regression(paddle, steps=300):
    """The verify recipe's eager flow: fit y = x w + b by hand."""
    rs = np.random.RandomState(1)
    xv = rs.rand(256, 3).astype("float32")
    true_w = np.array([[2.0], [-3.4], [1.7]], "float32")
    yv = xv @ true_w + 4.2
    x, y = paddle.to_tensor(xv), paddle.to_tensor(yv)
    w = paddle.to_tensor(np.zeros((3, 1), "float32"), stop_gradient=False)
    b = paddle.to_tensor(np.zeros((1,), "float32"), stop_gradient=False)
    opt = paddle.optimizer.SGD(learning_rate=0.5, parameters=[w, b])
    for _ in range(steps):
        loss = paddle.mean((paddle.matmul(x, w) + b - y) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
    return w.numpy(), b.numpy(), float(loss)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_linear_regression_reaches_the_known_weights(cpu, pkg):
    w, b, loss = _linear_regression(paddle_tpu if pkg == "jax" else cpu)
    np.testing.assert_allclose(w[:, 0], [2.0, -3.4, 1.7], atol=1e-3)
    np.testing.assert_allclose(b, [4.2], atol=1e-3)
    assert loss < 1e-5


def _payload(paddle):
    return {"w": paddle.to_tensor(np.arange(6, dtype="float32").reshape(
                2, 3)),
            "ids": paddle.to_tensor(np.array([3, 1, 2], "int32")),
            "step": 7, "name": "ckpt",
            "nested": {"layers": [paddle.ones([2]), {"b": paddle.zeros([1])}],
                       "arr": np.array([1.5, 2.5], "float32"),
                       "pair": (1, 2.5)}}


def _check(obj):
    np.testing.assert_array_equal(obj["w"].numpy(),
                                  np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(obj["ids"].numpy(), [3, 1, 2])
    assert obj["step"] == 7 and obj["name"] == "ckpt"
    np.testing.assert_array_equal(obj["nested"]["layers"][0].numpy(), [1, 1])
    np.testing.assert_array_equal(obj["nested"]["layers"][1]["b"].numpy(),
                                  [0])
    np.testing.assert_array_equal(obj["nested"]["arr"], [1.5, 2.5])
    assert isinstance(obj["nested"]["arr"], np.ndarray)
    assert obj["nested"]["pair"] == (1, 2.5)


def test_save_crosses_from_the_port_to_paddle_tpu(cpu, tmp_path):
    path = str(tmp_path / "port.pdparams")
    cpu.save(_payload(cpu), path)
    obj = paddle_tpu.load(path)
    _check(obj)
    assert isinstance(obj["w"], paddle_tpu.Tensor)


def test_save_crosses_from_paddle_tpu_to_the_port(cpu, tmp_path):
    path = str(tmp_path / "jax.pdparams")
    paddle_tpu.save(_payload(paddle_tpu), path)
    obj = cpu.load(path)
    _check(obj)
    assert isinstance(obj["w"], cpu.Tensor)
    assert obj["w"].device.type == "cpu"


def test_layer_and_optimizer_state_round_trip(cpu, tmp_path):
    model = TLeNet()
    opt = cpu.optimizer.Adam(1e-3, parameters=model.parameters())
    x, y = _batch()
    cpu.nn.functional.cross_entropy(model(cpu.to_tensor(x)),
                                    cpu.to_tensor(y)).backward()
    opt.step()
    cpu.save(model.state_dict(), str(tmp_path / "m.pdparams"))
    cpu.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    model2 = TLeNet()
    missing, unexpected = model2.set_state_dict(
        cpu.load(str(tmp_path / "m.pdparams")))
    assert missing == [] and unexpected == []
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    opt2 = cpu.optimizer.Adam(1e-3, parameters=model2.parameters())
    opt2.set_state_dict(cpu.load(str(tmp_path / "m.pdopt")))
    a, b = opt.state_dict(), opt2.state_dict()
    assert a["step"] == b["step"] == 1 and sorted(a["slots"]) == sorted(
        b["slots"])
    for i in a["slots"]:
        for k in a["slots"][i]:
            np.testing.assert_array_equal(a["slots"][i][k].numpy(),
                                          b["slots"][i][k].numpy())


def test_save_refuses_what_is_not_ported(cpu, tmp_path):
    """Encrypted saves and ``scheme://`` paths are ported: an encrypted
    file round-trips and loads in paddle_tpu with the same key, and a
    ``hdfs://`` path goes to the ``hadoop`` CLI, whose absence both
    packages report as a permanent filesystem error."""
    from paddle_tpu.utils import fs as jfs
    from paddle_tpu_torch.utils import fs
    key = b"k" * 32
    p = str(tmp_path / "x")
    cpu.save({"a": 1, "w": np.arange(3.0)}, p, encryption_key=key)
    for load in (cpu.load, paddle_tpu.load):
        out = load(p, encryption_key=key)
        assert out["a"] == 1
        np.testing.assert_array_equal(np.asarray(out["w"]), np.arange(3.0))
    with pytest.raises(ValueError, match="encrypted"):
        cpu.load(p)
    for save, err in ((cpu.save, fs.PermanentFSError),
                      (paddle_tpu.save, jfs.PermanentFSError)):
        with pytest.raises(err, match="CLI not found"):
            save({"a": 1}, "hdfs://host/x")
