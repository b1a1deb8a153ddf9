"""The eager Layer and the conv, pooling, activation and loss layers of
the port against paddle_tpu's, on the CPU: each layer with the same
weights gives the same output and input gradient (rtol 1e-5), and the
Layer's paddle methods behave as paddle_tpu's do."""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


rs = np.random.RandomState(0)
IMG = rs.randn(2, 3, 9, 8).astype("float32")
SEQ = rs.randn(2, 3, 10).astype("float32")
VOL = rs.randn(1, 2, 5, 6, 4).astype("float32")
ROWS = rs.randn(6, 5).astype("float32")
LAB = rs.randint(0, 5, (6,)).astype("int64")
PROB = rs.rand(6, 5).astype("float32") * 0.9 + 0.05
BIN = (rs.rand(6, 5) > 0.5).astype("float32")

# name -> (make(nn) -> layer, input)
LAYERS = {
    "Conv2D": (lambda nn: nn.Conv2D(3, 4, 3, stride=2, padding=1), IMG),
    "Conv2D_groups_dilation": (lambda nn: nn.Conv2D(
        3, 6, (3, 2), padding=[1, 0], dilation=2, groups=3), IMG),
    "Conv2D_same": (lambda nn: nn.Conv2D(3, 2, 4, stride=2,
                                         padding="SAME"), IMG),
    "Conv2D_uneven": (lambda nn: nn.Conv2D(3, 2, 3,
                                           padding=[1, 0, 2, 1]), IMG),
    "Conv2D_nhwc": (lambda nn: nn.Conv2D(8, 2, 3, padding=1,
                                         data_format="NHWC"), IMG),
    "Conv1D": (lambda nn: nn.Conv1D(3, 4, 3, padding=1), SEQ),
    "Conv3D": (lambda nn: nn.Conv3D(2, 3, 3, padding=1), VOL),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(
        3, 2, 3, stride=2, padding=1, output_padding=1), IMG),
    "Conv2DTranspose_groups": (lambda nn: nn.Conv2DTranspose(
        3, 6, 2, stride=2, groups=3), IMG),
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(3, 2, 4, stride=2,
                                                      padding=1), SEQ),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(2, 2, 2, stride=2),
                        VOL),
    "MaxPool2D": (lambda nn: nn.MaxPool2D(2, 2), IMG),
    "MaxPool2D_pad": (lambda nn: nn.MaxPool2D(3, 2, padding=1), IMG),
    "AvgPool2D": (lambda nn: nn.AvgPool2D(3, 2, padding=1), IMG),
    "AvgPool2D_inclusive": (lambda nn: nn.AvgPool2D(3, 2, padding=1,
                                                    exclusive=False), IMG),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(3, 2), SEQ),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(2), SEQ),
    "MaxPool3D": (lambda nn: nn.MaxPool3D(2), VOL),
    "AvgPool3D": (lambda nn: nn.AvgPool3D(2, padding=1), VOL),
    "AdaptiveAvgPool2D": (lambda nn: nn.AdaptiveAvgPool2D((4, 3)), IMG),
    "AdaptiveMaxPool2D": (lambda nn: nn.AdaptiveMaxPool2D(4), IMG),
    "AdaptiveAvgPool1D": (lambda nn: nn.AdaptiveAvgPool1D(3), SEQ),
    "AdaptiveMaxPool1D": (lambda nn: nn.AdaptiveMaxPool1D(4), SEQ),
    "AdaptiveAvgPool3D": (lambda nn: nn.AdaptiveAvgPool3D(2), VOL),
    "AdaptiveMaxPool3D": (lambda nn: nn.AdaptiveMaxPool3D(2), VOL),
    **{n: ((lambda n: lambda nn: getattr(nn, n)())(n), ROWS)
       for n in ("ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish",
                 "Softsign", "Tanhshrink", "Hardswish", "Hardsigmoid",
                 "LogSigmoid", "GELU", "LeakyReLU", "ELU", "SELU", "CELU",
                 "Hardtanh", "Hardshrink", "Softshrink", "Softplus",
                 "Softmax", "LogSoftmax", "ThresholdedReLU")},
    "GELU_tanh": (lambda nn: nn.GELU(approximate=True), ROWS),
    "GLU": (lambda nn: nn.GLU(), IMG),
    "Maxout": (lambda nn: nn.Maxout(3, axis=1), IMG),
    "PReLU": (lambda nn: nn.PReLU(3, 0.1), IMG),
    "Sequential": (lambda nn: nn.Sequential(nn.Linear(5, 4), nn.ReLU(),
                                            nn.Linear(4, 2)), ROWS),
}


def _carry(jl, tl):
    init = {k: np.asarray(v.data) for k, v in jl.state_dict().items()}
    tl.set_state_dict(state_dict_from_paddle_tpu(init, device="cpu",
                                                 model=tl))


def _run(paddle, layer, x):
    xt = paddle.to_tensor(x, stop_gradient=False)
    out = layer(xt)
    (out * out).sum().backward()
    return np.asarray(out.numpy()), np.asarray(xt.grad.numpy())


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_paddle_tpu(cpu, name):
    make, x = LAYERS[name]
    paddle_tpu.seed(0)
    jl, tl = make(paddle_tpu.nn), make(cpu.nn)
    assert sorted(tl.state_dict()) == sorted(jl.state_dict())
    _carry(jl, tl)
    jo, jg = _run(paddle_tpu, jl, x)
    to, tg = _run(cpu, tl, x)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)


LOSSES = {
    "CrossEntropyLoss": (lambda nn: nn.CrossEntropyLoss(), ROWS, LAB),
    "CrossEntropyLoss_smooth": (lambda nn: nn.CrossEntropyLoss(
        label_smoothing=0.1, reduction="sum"), ROWS, LAB),
    "MSELoss": (lambda nn: nn.MSELoss(), ROWS, PROB),
    "L1Loss": (lambda nn: nn.L1Loss(reduction="sum"), ROWS, PROB),
    "NLLLoss": (lambda nn: nn.NLLLoss(), ROWS, LAB),
    "BCELoss": (lambda nn: nn.BCELoss(), PROB, BIN),
    "BCEWithLogitsLoss": (lambda nn: nn.BCEWithLogitsLoss(
        reduction="none"), ROWS, BIN),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_paddle_tpu(cpu, name):
    make, x, lab = LOSSES[name]
    outs = []
    for p in (paddle_tpu, cpu):
        xt = p.to_tensor(x, stop_gradient=False)
        loss = make(p.nn)(xt, p.to_tensor(lab))
        p.sum(loss).backward()
        outs.append((np.asarray(loss.numpy()), np.asarray(xt.grad.numpy())))
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["softmax_with_cross_entropy",
                                  "bce_with_logits_pos_weight",
                                  "smooth_l1_loss"])
def test_functional_loss_matches_paddle_tpu(cpu, name):
    outs = []
    for p in (paddle_tpu, cpu):
        F = p.nn.functional
        x = p.to_tensor(ROWS)
        if name == "softmax_with_cross_entropy":
            out = F.softmax_with_cross_entropy(x, p.to_tensor(LAB[:, None]))
        elif name == "smooth_l1_loss":
            out = F.smooth_l1_loss(x, p.to_tensor(PROB), delta=0.5)
        else:
            out = F.binary_cross_entropy_with_logits(
                x, p.to_tensor(BIN), pos_weight=p.to_tensor(
                    np.full(5, 2.0, "float32")))
        outs.append(np.asarray(out.numpy()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


# -- the Layer's own methods ----------------------------------------------------

def _net(nn):
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.body = nn.Sequential(nn.Linear(4, 3), nn.ReLU())
            self.head = nn.LayerList([nn.Linear(3, 2)])
            self.register_buffer("scale", paddle_tpu_torch.ones([2]) if
                                 nn is paddle_tpu_torch.nn else
                                 paddle_tpu.ones([2]))
            self.register_buffer("cache", paddle_tpu_torch.zeros([1]) if
                                 nn is paddle_tpu_torch.nn else
                                 paddle_tpu.zeros([1]), persistable=False)
            self.w = self.create_parameter([2], default_initializer=(
                nn.initializer.Constant(0.5)))

        def forward(self, x):
            return self.head[0](self.body(x)) * self.scale * self.w
    return Net()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_layer_methods(cpu, pkg):
    paddle = paddle_tpu if pkg == "jax" else cpu
    net = _net(paddle.nn)
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 5
    assert [n for n, _ in net.named_parameters()] == [
        "w", "body.0.weight", "body.0.bias", "head.0.weight", "head.0.bias"]
    assert sorted(net.state_dict()) == sorted(
        ["w", "body.0.weight", "body.0.bias", "head.0.weight",
         "head.0.bias", "scale"])
    assert [type(l).__name__ for l in net.sublayers()] == [
        "Sequential", "Linear", "ReLU", "LayerList", "Linear"]
    assert [n for n, _ in net.named_sublayers()] == [
        "body", "body.0", "body.1", "head", "head.0"]
    seen = []
    h = net.register_forward_pre_hook(lambda layer, inp: seen.append("pre"))
    h2 = net.register_forward_post_hook(
        lambda layer, inp, out: seen.append("post"))
    x = paddle.to_tensor(np.ones((2, 4), "float32"))
    net(x).sum().backward()
    assert seen == ["pre", "post"]
    h.remove()
    h2.remove()
    net(x)
    assert seen == ["pre", "post"]
    assert all(p.grad is not None for p in net.parameters())
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    net.eval()
    assert not net.training and not net.body[0].training
    net.train()
    assert net.training
    sd = {k: np.full(v.shape, 2.0, "float32")
          for k, v in net.state_dict().items()}
    missing, unexpected = net.set_state_dict(dict(sd, extra=np.ones(1)))
    assert missing == [] and unexpected == ["extra"]
    np.testing.assert_array_equal(net.w.numpy(), [2.0, 2.0])
    with pytest.raises(ValueError):
        net.set_state_dict({"w": np.ones(3, "float32")})
    assert isinstance(net.full_name(), str)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_param_attr_learning_rate_and_regularizer(cpu, pkg):
    """A parameter's own regularizer wins over the optimizer's decay and
    its learning rate scales the optimizer's (clip first, then decay)."""
    paddle = paddle_tpu if pkg == "jax" else cpu
    paddle.seed(0)
    lin = paddle.nn.Linear(4, 3, weight_attr=paddle.ParamAttr(
        initializer=paddle.nn.initializer.Constant(0.3), learning_rate=0.5,
        regularizer=paddle.regularizer.L1Decay(0.01)))
    opt = paddle.optimizer.SGD(
        0.1, parameters=lin.parameters(),
        weight_decay=paddle.regularizer.L2Decay(0.1),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    x = paddle.to_tensor(np.arange(8, dtype="float32").reshape(2, 4))
    lin(x).sum().backward()
    g_w, g_b = lin.weight.grad.numpy().copy(), lin.bias.grad.numpy().copy()
    opt.step()
    scale = min(1.0, 0.5 / np.sqrt((g_w ** 2).sum() + (g_b ** 2).sum()))
    want_w = 0.3 - 0.1 * 0.5 * (g_w * scale + 0.01 * np.sign(0.3))
    want_b = 0.0 - 0.1 * (g_b * scale + 0.1 * 0.0)
    np.testing.assert_allclose(lin.weight.numpy(), want_w, rtol=1e-5)
    np.testing.assert_allclose(lin.bias.numpy(), want_b, rtol=1e-5,
                               atol=1e-7)


def test_kept_differences_of_the_layers(cpu, tmp_path):
    """``ceil_mode`` is honoured (paddle_tpu ignores it); a
    ``padding_mode`` other than 'zeros' raises (paddle_tpu ignores it);
    ``paddle.save`` writes bfloat16 as float32."""
    x = IMG[:, :, :9, :7]
    got = cpu.nn.MaxPool2D(2, 2, ceil_mode=True)(cpu.to_tensor(x))
    assert got.shape == [2, 3, 5, 4]
    assert paddle_tpu.nn.MaxPool2D(2, 2, ceil_mode=True)(
        paddle_tpu.to_tensor(x)).shape == [2, 3, 4, 3]
    with pytest.raises(NotImplementedError):
        cpu.nn.Conv2D(3, 2, 3, padding_mode="reflect")
    path = str(tmp_path / "bf16.pdparams")
    cpu.save({"w": cpu.ones([2], dtype="bfloat16")}, path)
    assert paddle_tpu.load(path)["w"].dtype == paddle_tpu.float32
    assert cpu.load(path)["w"].dtype == cpu.float32
