"""``onnx.export`` held to paddle_tpu's on the CPU: the assertions of
``tests/test_onnx_export.py`` on the port's file, decoded by ``protoc``
against the vendored schema subset (``tests/data/onnx_subset.proto``),
and both packages' files for the same weights run through
``paddle_tpu_torch.testing.onnx_eval``: the same outputs within
``ATOL``, and each the exporting model's forward within ``ATOL``.

Kept difference: the port's file names its producer
``paddle_tpu_torch``; paddle_tpu's names ``paddle_tpu``."""
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu.jit import InputSpec as JSpec

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.jit import InputSpec as TSpec
from paddle_tpu_torch.testing import onnx_eval

ATOL = 1e-5
_PROTO_DIR = os.path.join(os.path.dirname(__file__), "data")
SIDES = {"jax": (jpaddle, jnn, JSpec), "torch": (tpaddle, tnn, TSpec)}


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)


def _decode(path):
    assert shutil.which("protoc"), "protoc is part of this test's setup"
    with open(path, "rb") as f:
        out = subprocess.run(
            ["protoc", "--decode=onnx.ModelProto",
             f"--proto_path={_PROTO_DIR}", "onnx_subset.proto"],
            stdin=f, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-500:]
    return out.stdout


def _pair(build, seed):
    jpaddle.seed(seed)
    jm, tm = build(jnn), build(tnn)
    state = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
    tm.set_state_dict(state_dict_from_paddle_tpu(state, "cpu", model=tm))
    jm.eval(), tm.eval()
    return {"jax": jm, "torch": tm}


def _mlp(nn):
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _cnn(nn):
    return nn.Sequential(nn.Conv2D(1, 4, 3, padding=1), nn.ReLU(),
                         nn.MaxPool2D(2), nn.Flatten(),
                         nn.Linear(4 * 4 * 4, 3))


def _act(nn):
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4)

        def forward(self, x):
            P = jpaddle if nn is jnn else tpaddle
            return P.nn.functional.softmax(P.tanh(self.fc(x)), axis=-1)
    return Net()


def _sum(nn):
    class MeanNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 6)

        def forward(self, x):
            return self.fc(x).sum(axis=-1)
    return MeanNet()


def _bn_cnn(nn):
    return nn.Sequential(nn.Conv2D(3, 8, 3, stride=2, padding=1),
                         nn.BatchNorm2D(8), nn.ReLU(),
                         nn.Conv2D(8, 8, 3, padding=1, bias_attr=False),
                         nn.BatchNorm2D(8), nn.ReLU(),
                         nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                         nn.Linear(8, 5))


MODELS = {"mlp": (_mlp, [None, 8], 96), "cnn": (_cnn, [1, 1, 8, 8], 97),
          "act": (_act, [2, 4], 99), "sum": (_sum, [2, 4], 103),
          "bn_cnn": (_bn_cnn, [2, 3, 16, 16], 104)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each model of ``MODELS`` built by both packages from the same
    weights and exported by each, once a module: name -> (models,
    paths)."""
    tpaddle.set_device("cpu")
    d = tmp_path_factory.mktemp("onnx")
    out = {}
    for name, (build, shape, seed) in MODELS.items():
        models = _pair(build, seed)
        out[name] = (models, {
            k: P.onnx.export(models[k], str(d / f"{name}_{k}"),
                             input_spec=[S(shape, "float32")])
            for k, (P, _, S) in SIDES.items()})
    placement.set_default(None)
    return out


# -- tests/test_onnx_export.py's assertions, on the port's file -------------

def test_mlp_export_protoc_verified(files):
    _, paths = files["mlp"]
    p = paths["torch"]
    assert p.endswith(".onnx") and os.path.exists(p)
    txt = _decode(p)
    assert 'op_type: "MatMul"' in txt
    assert 'op_type: "Max"' in txt          # relu = max(x, 0)
    assert 'producer_name: "paddle_tpu_torch"' in txt
    assert txt.count("initializer") >= 4     # 2 weights + 2 biases
    assert 'input: "input_0"' in txt
    assert "opset_import" in txt and "version: 13" in txt
    # the None dim is specialised to 1
    graph_in = txt.split("\n  input {", 1)[1].split("\n  }", 1)[0]
    assert "dim_value: 1" in graph_in and "dim_value: 8" in graph_in


def test_cnn_export_has_conv_and_pool(files):
    _, paths = files["cnn"]
    txt = _decode(paths["torch"])
    assert 'op_type: "Conv"' in txt
    assert 'op_type: "MaxPool"' in txt
    for op in ("Conv", "MaxPool"):
        block = txt.split(f'op_type: "{op}"')[1].split("node {")[0]
        assert "kernel_shape" in block and "strides" in block, block


def test_initializer_bytes_roundtrip(tmp_path):
    """The exported initializers' raw_data are the live weights' bytes."""
    tpaddle.seed(98)
    net = tnn.Linear(4, 3)
    p = tpaddle.onnx.export(net, str(tmp_path / "lin"),
                            input_spec=[TSpec([2, 4], "float32")])
    blob = open(p, "rb").read()
    assert net.weight.detach().numpy().tobytes() in blob
    assert net.bias.detach().numpy().tobytes() in blob
    inits = onnx_eval.load(p)["initializers"]
    got = sorted((a.shape, a.tobytes()) for a in inits.values()
                 if a.ndim >= 1 and a.size >= 3)
    want = sorted((tuple(t.shape), t.detach().numpy().tobytes())
                  for t in (net.weight, net.bias))
    assert got == want


def test_unsupported_op_is_loud(tmp_path):
    class Weird(tnn.Layer):
        def forward(self, x):
            return tpaddle.sort(x)     # 'sort' is outside the subset

    with pytest.raises(NotImplementedError, match="sort"):
        tpaddle.onnx.export(Weird(), str(tmp_path / "w"),
                            input_spec=[TSpec([4], "float32")])


def test_a_hand_kernel_custom_op_is_loud(tmp_path):
    """The port's kernels are custom ops in the exported graph (as
    paddle_tpu's are ``pallas_call``): no ONNX form, named in the
    error."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention

    class Attn(tnn.Layer):
        def forward(self, q):
            return flash_attention(q, q, q)

    with pytest.raises(NotImplementedError,
                       match="paddle_tpu_torch::flash_attention_fwd"):
        tpaddle.onnx.export(Attn(), str(tmp_path / "a"),
                            input_spec=[TSpec([1, 8, 2, 64], "float32")])


def test_sigmoid_tanh_softmax_graph(files):
    _, paths = files["act"]
    txt = _decode(paths["torch"])
    assert 'op_type: "Tanh"' in txt
    assert 'op_type: "Exp"' in txt or 'op_type: "Softmax"' in txt


def test_reduce_sum_axes_as_input_opset13(files):
    _, paths = files["sum"]
    txt = _decode(paths["torch"])
    block = txt.split('op_type: "ReduceSum"')[0].rsplit("node {", 1)[1]
    assert block.count("input:") == 2, block     # data + axes input
    assert 'name: "axes' in txt                  # axes initializer


def test_batch_norm_in_eval_is_elementwise(files):
    _, paths = files["bn_cnn"]
    hist = onnx_eval.histogram(onnx_eval.load(paths["torch"]))
    assert "BatchNormalization" not in hist
    assert hist["Conv"] == 2 and hist["Sqrt"] == 2 and hist["Sub"] == 2


# -- both packages' files, run --------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_both_packages_files_give_the_same_outputs(name, files):
    models, paths = files[name]
    shape = [1 if d is None else d for d in MODELS[name][1]]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    outs = {k: onnx_eval.run(onnx_eval.load(p), [torch.from_numpy(x)])[0]
            .numpy() for k, p in paths.items()}
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=ATOL)
    fwd = models["torch"](tpaddle.to_tensor(x)).detach().numpy()
    np.testing.assert_allclose(outs["torch"], fwd, atol=ATOL)
    jfwd = np.asarray(models["jax"](jpaddle.to_tensor(x)).data)
    np.testing.assert_allclose(outs["jax"], jfwd, atol=ATOL)


def test_resnet_graph_reproduces_the_forward(tmp_path):
    """``vision.models.resnet18`` (batch norm, residual adds, max and
    global-average pools) at 32 px: the exported graph, run node by
    node, gives the model's eval forward."""
    import paddle_tpu_torch.vision.models as TM
    tpaddle.seed(5)
    m = TM.resnet18(num_classes=10)
    m.eval()
    p = tpaddle.onnx.export(m, str(tmp_path / "r18"),
                            input_spec=[TSpec([None, 3, 32, 32])])
    model = onnx_eval.load(p)
    hist = onnx_eval.histogram(model)
    assert hist["Conv"] == 20 and hist["MaxPool"] == 1
    assert hist.get("GlobalAveragePool", 0) + hist.get("ReduceMean", 0) == 1
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 3, 32, 32)
                         .astype(np.float32))
    got = onnx_eval.run(model, [x])[0]
    want = m(tpaddle.to_tensor(x.numpy()))
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               rtol=1e-4, atol=ATOL)
