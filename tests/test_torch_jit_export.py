"""paddle_tpu_torch's ``jit.to_static``, ``jit.save``/``jit.load`` and
``static.save_inference_model``/``load_inference_model`` held to
paddle_tpu's on the CPU.

- The cases of ``tests/test_jit.py``: ``to_static`` outputs and
  gradients, the decorator on a layer's method, two shapes through one
  function, batch norm's running statistics, dropout under a seed,
  ``TrainStep`` against the eager loop (SGD), with Adam and a clip, its
  ``eval_step``, and the save/load round trip (at batches 7, 2 and 1
  against an example of 2);
- LeNet, the bench_serving MLP and a small BERT (``bench.build_model``,
  2 layers, hidden 128, head dim 64, so the flash gate takes it) saved
  by both packages from the same weights, loaded and run at batches 1
  and 3: the outputs agree within rtol/atol 1e-5 (f32);
- the static BERT (``bench.build_bert_static``, 2 layers) saved by both
  packages with the logits as the fetch variable and run through
  ``load_inference_model`` + ``Executor.run``;
- the graphs: the small BERT's holds the K1f custom op
  (``paddle_tpu_torch::flash_attention_fwd``) once a layer and no
  SDPA or softmax node in its place; the static BERT's holds K2f
  (``paddle_tpu_torch::fused_linear_epilogue_fwd``) three times a layer
  and K1f once;
- an artifact loads and runs in a fresh process that imports only
  paddle_tpu_torch (neither ``jax`` nor ``paddle_tpu`` in
  ``sys.modules``); a paddle_tpu artifact is refused naming both
  formats; a dim declared dynamic that the forward fixes, and a Python
  ``if`` on a tensor, are refused; the layer's mode survives a save.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.framework_io import (program_state_from_paddle_tpu,
                                           state_dict_from_paddle_tpu)
from paddle_tpu_torch.jit.save_load import SUFFIX_MODEL, read_artifact
from paddle_tpu_torch.testing.models import build_bert_static, build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = (paddle_tpu, paddle_tpu_torch)
TOL = dict(rtol=1e-5, atol=1e-5)
BERT = dict(vocab=1000, hidden=128, layers=2, heads=2, ffn=256, seq=64)
FLASH = "paddle_tpu_torch::flash_attention_fwd"
EPILOGUE = "paddle_tpu_torch::fused_linear_epilogue_fwd"


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _carry(jlayer, tlayer):
    """The JAX layer's weights into the port's layer."""
    state = {k: _np(v) for k, v in jlayer.state_dict().items()}
    tlayer.load_state_dict(state_dict_from_paddle_tpu(state, "cpu",
                                                      model=tlayer))
    return tlayer


def _mlp_pair(sizes=(4, 16, 2)):
    """``tests/test_jit.py``'s ``_model`` in both packages, one set of
    weights."""
    out = []
    for paddle in SIDES:
        paddle.seed(1)
        layers = []
        for a, b in zip(sizes[:-1], sizes[1:]):
            layers += [paddle.nn.Linear(a, b), paddle.nn.ReLU()]
        out.append(paddle.nn.Sequential(*layers[:-1]))
    return out[0], _carry(out[0], out[1])


def _lenet_pair():
    jm = paddle_tpu.vision.models.LeNet()
    return jm, _carry(jm, paddle_tpu_torch.vision.models.LeNet())


def _bert_pair():
    jm = _bench().build_model(**BERT, dropout=0.0)
    return jm, _carry(jm, build_model(**BERT, dropout=0.0, device="cpu"))


def _save_load_both(pair, tmp_path, spec):
    """Each package saves its layer with ``spec`` and loads it back."""
    loaded = []
    for paddle, layer in zip(SIDES, pair):
        path = str(tmp_path / paddle.__name__)
        paddle.jit.save(layer, path, input_spec=[paddle.jit.InputSpec(*spec)])
        loaded.append(paddle.jit.load(path))
    return loaded


def _targets(program):
    return [str(n.target) for gm in program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function"]


# ------------------------------------------------------------ to_static --
def test_to_static_output_parity(cpu):
    outs = []
    x = np.random.RandomState(0).standard_normal((6, 4)).astype("float32")
    for paddle, m in zip(SIDES, _mlp_pair()):
        eager = m(paddle.to_tensor(x)).numpy()
        static = paddle.jit.to_static(m.forward)(paddle.to_tensor(x)).numpy()
        np.testing.assert_allclose(static, eager, rtol=1e-6)
        outs.append(static)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_to_static_grad_parity(cpu):
    x = np.random.RandomState(1).standard_normal((6, 4)).astype("float32")
    y = np.array([0, 1, 0, 1, 0, 1])
    grads = []
    for paddle, m in zip(SIDES, _mlp_pair()):
        lossf = paddle.nn.CrossEntropyLoss()
        fwd = paddle.jit.to_static(m.forward)
        lossf(fwd(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
        gs = m[0].weight.grad.numpy().copy()
        m.clear_gradients()
        lossf(m(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
        np.testing.assert_allclose(gs, m[0].weight.grad.numpy(), rtol=1e-4,
                                   atol=1e-6)
        grads.append(gs)
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


def test_to_static_decorator_on_layer(cpu):
    x = np.random.RandomState(2).standard_normal((2, 3)).astype("float32")
    outs = []
    for paddle in SIDES:
        class Net(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = paddle.nn.Linear(3, 3)

            @paddle.jit.to_static
            def forward(self, v):
                return self.fc(v) * 2

        net = Net()
        w = np.arange(9, dtype="float32").reshape(3, 3) / 10
        net.fc.weight.set_value(w)
        net.fc.bias.set_value(np.ones(3, "float32"))
        out = net(paddle.to_tensor(x)).numpy()
        np.testing.assert_allclose(out, (x @ w + 1) * 2, rtol=1e-5)
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


@pytest.mark.parametrize("batches", [(2, 5), (1, 7)])
def test_to_static_respects_shape_cache(cpu, batches):
    r = np.random.RandomState(3)
    xs = [r.standard_normal((b, 4)).astype("float32") for b in batches]
    outs = []
    for paddle, m in zip(SIDES, _mlp_pair()):
        fwd = paddle.jit.to_static(m.forward)
        got = [fwd(paddle.to_tensor(x)) for x in xs]
        assert [g.shape for g in got] == [[b, 2] for b in batches]
        outs.append([g.numpy() for g in got])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, **TOL)


def test_to_static_batchnorm_buffer_update(cpu):
    x = (np.random.RandomState(4).standard_normal((16, 4)) * 3
         + 1).astype("float32")
    means = []
    for paddle in SIDES:
        bn = paddle.nn.BatchNorm1D(4)
        bn.train()
        fwd = paddle.jit.to_static(bn.forward)
        before = bn._mean.numpy().copy()
        fwd(paddle.to_tensor(x))
        after = bn._mean.numpy()
        assert not np.allclose(before, after), "running mean must update"
        means.append((after, bn._variance.numpy()))
    for a, b in zip(*means):
        np.testing.assert_allclose(b, a, **TOL)


def test_static_function_with_dropout_varies_but_deterministic_under_seed(
        cpu):
    for paddle in SIDES:
        drop = paddle.nn.Dropout(0.5)
        drop.train()
        fwd = paddle.jit.to_static(drop.forward)
        x = paddle.ones([100])
        paddle.seed(11)
        a = fwd(x).numpy()
        b = fwd(x).numpy()
        assert not np.allclose(a, b), "different calls draw different masks"
        paddle.seed(11)
        np.testing.assert_allclose(fwd(x).numpy(), a)
        assert set(np.unique(a)) <= {0.0, 2.0}


def test_train_step_converges_and_matches_eager(cpu):
    """``tests/test_jit.py``'s SGD case: the TrainStep and the eager loop
    agree on each package, and the packages agree."""
    x = np.random.RandomState(10).standard_normal((16, 4)).astype("float32")
    y = np.random.RandomState(11).standard_normal((16, 1)).astype("float32")
    losses = []
    jm = paddle_tpu.nn.Sequential(paddle_tpu.nn.Linear(4, 8),
                                  paddle_tpu.nn.Tanh(),
                                  paddle_tpu.nn.Linear(8, 1))
    for paddle in SIDES:
        m1 = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.Tanh(),
                                  paddle.nn.Linear(8, 1))
        m2 = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.Tanh(),
                                  paddle.nn.Linear(8, 1))
        for m in (m1, m2):
            if paddle is paddle_tpu:
                m.set_state_dict(jm.state_dict())
            else:
                _carry(jm, m)
        lossf = paddle.nn.MSELoss()
        o1 = paddle.optimizer.SGD(learning_rate=0.1,
                                  parameters=m1.parameters())
        o2 = paddle.optimizer.SGD(learning_rate=0.1,
                                  parameters=m2.parameters())
        step = paddle.jit.TrainStep(m1, lossf, o1)
        X, Y = paddle.to_tensor(x), paddle.to_tensor(y)
        got = []
        for _ in range(5):
            l_jit = float(step(X, Y))
            loss = lossf(m2(X), Y)
            loss.backward()
            o2.step()
            o2.clear_grad()
            np.testing.assert_allclose(l_jit, float(loss), rtol=1e-4)
            got.append(l_jit)
        np.testing.assert_allclose(_np(m1[0].weight), _np(m2[0].weight),
                                   rtol=1e-4, atol=1e-6)
        losses.append((got, _np(m1[0].weight)))
    np.testing.assert_allclose(losses[1][0], losses[0][0], **TOL)
    np.testing.assert_allclose(losses[1][1], losses[0][1], **TOL)


def test_train_step_adam_with_clip(cpu):
    x = np.random.RandomState(12).standard_normal((32, 4)).astype("float32")
    y = np.random.RandomState(13).randint(0, 2, (32,))
    losses = []
    for paddle, m in zip(SIDES, _mlp_pair()):
        opt = paddle.optimizer.Adam(
            learning_rate=0.01, parameters=m.parameters(),
            grad_clip=paddle.optimizer.ClipGradByGlobalNorm(1.0))
        step = paddle.jit.TrainStep(m, paddle.nn.CrossEntropyLoss(), opt)
        X, Y = paddle.to_tensor(x), paddle.to_tensor(y)
        got = [float(step(X, Y)) for _ in range(30)]
        assert got[-1] < got[0]
        losses.append(got)
    np.testing.assert_allclose(losses[1], losses[0], **TOL)


def test_eval_step(cpu):
    x = np.random.RandomState(14).standard_normal((4, 4)).astype("float32")
    y = np.array([0, 1, 1, 0])
    outs = []
    for paddle, m in zip(SIDES, _mlp_pair()):
        m.eval()
        before = [_np(p).copy() for p in m.parameters()]
        step = paddle.jit.TrainStep(m, paddle.nn.CrossEntropyLoss(),
                                    paddle.optimizer.SGD(
                                        0.1, parameters=m.parameters()))
        X, Y = paddle.to_tensor(x), paddle.to_tensor(y)
        loss, out = step.eval_step(X, Y)
        assert out.shape == [4, 2]
        np.testing.assert_allclose(
            float(loss), float(paddle.nn.CrossEntropyLoss()(m(X), Y)),
            rtol=1e-5)
        for b, p in zip(before, m.parameters()):
            np.testing.assert_array_equal(_np(p), b)   # nothing updated
        outs.append((float(loss), _np(out)))
    np.testing.assert_allclose(outs[1][0], outs[0][0], **TOL)
    np.testing.assert_allclose(outs[1][1], outs[0][1], **TOL)


# ------------------------------------------------------------ save/load --
@pytest.mark.parametrize("batch", [7, 2, 1])
def test_jit_save_load_roundtrip(cpu, tmp_path, batch):
    pair = _mlp_pair()
    for m in pair:
        m.eval()
    jl, tl = _save_load_both(pair, tmp_path, ([None, 4],))
    x = np.random.RandomState(batch).standard_normal((batch, 4)).astype(
        "float32")
    want = _np(pair[0](paddle_tpu.to_tensor(x)))
    got = tl(paddle_tpu_torch.to_tensor(x))
    assert isinstance(got, paddle_tpu_torch.Tensor) and got.shape == [
        batch, 2]
    np.testing.assert_allclose(got.numpy(), _np(jl(paddle_tpu.to_tensor(x))),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), pair[1](paddle_tpu_torch.to_tensor(x)).numpy(),
        rtol=0, atol=0)


@pytest.mark.parametrize("model,spec,batches", [
    ("lenet", ([None, 1, 28, 28], "float32"), (1, 3)),
    ("mlp", ([None, 64], "float32"), (1, 4, 5)),
    ("bert", ([None, BERT["seq"]], "int64"), (1, 3)),
])
def test_saved_models_match_paddle_tpu(cpu, tmp_path, model, spec, batches):
    """The port saves once with the dynamic batch and serves every batch.
    paddle_tpu's BERT cannot be exported with a symbolic batch (its
    attention reshape reads the batch as an int), so for it paddle_tpu
    saves one artifact per batch."""
    pair = {"lenet": _lenet_pair, "bert": _bert_pair,
            "mlp": lambda: _mlp_pair((64, 128, 128, 32))}[model]()
    for m in pair:
        m.eval()
    path = str(tmp_path / "port")
    paddle_tpu_torch.jit.save(pair[1], path, input_spec=[
        paddle_tpu_torch.jit.InputSpec(*spec)])
    tl = paddle_tpu_torch.jit.load(path)
    r = np.random.RandomState(5)
    for b in batches:
        shape = [b] + list(spec[0][1:])
        jspec = shape if model == "bert" else spec[0]
        jpath = str(tmp_path / f"jax{b}")
        paddle_tpu.jit.save(pair[0], jpath, input_spec=[
            paddle_tpu.jit.InputSpec(jspec, spec[1])])
        x = (r.randint(0, BERT["vocab"], shape).astype("int64")
             if spec[1] == "int64" else
             r.standard_normal(shape).astype("float32"))
        want = _np(paddle_tpu.jit.load(jpath)(paddle_tpu.to_tensor(x)))
        got = tl(torch.from_numpy(x))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bert_graph_holds_the_flash_kernel(cpu, tmp_path):
    m = build_model(**BERT, dropout=0.1, device="cpu")
    path = str(tmp_path / "bert")
    paddle_tpu_torch.jit.save(m, path, input_spec=[
        paddle_tpu_torch.jit.InputSpec([None, BERT["seq"]], "int64")])
    assert m.training                      # the mode it was in
    meta, program = read_artifact(path)
    assert meta["kernels"] == {FLASH: BERT["layers"]}
    targets = _targets(program)
    assert targets.count("paddle_tpu_torch.flash_attention_fwd.default") \
        == BERT["layers"]
    plain = [t for t in targets if any(k in t for k in (
        "scaled_dot_product", "softmax", "einsum", "bmm", "baddbmm",
        "exp.default", "dropout"))]
    assert plain == []
    # dropout off in the artifact: it gives the eval forward
    ids = np.random.RandomState(6).randint(0, BERT["vocab"], (2, BERT["seq"]))
    got = paddle_tpu_torch.jit.load(path)(torch.from_numpy(ids))
    m.eval()
    np.testing.assert_allclose(got.numpy(), m(torch.from_numpy(ids))
                               .detach().numpy(), rtol=0, atol=0)


@pytest.fixture
def static_mode(cpu):
    for paddle in SIDES:
        paddle.enable_static()
    paddle_tpu.core.flags.set_flags({"pallas_interpret": True})
    yield
    paddle_tpu.core.flags.set_flags({"pallas_interpret": False})
    set_flags({"use_pallas_kernels": True})
    for paddle in SIDES:
        paddle.disable_static()
        paddle.static.reset_default_programs()


def _static_bert_pair(batch):
    c = dict(BERT, heads=2, batch=batch)
    jmain, _, _ = _bench().build_bert_static(**c)
    main, _, _ = build_bert_static(**c, device="cpu")
    program_state_from_paddle_tpu(
        main, [np.asarray(p.data) for p in jmain.parameters()],
        [np.asarray(v) for n in jmain.nodes for tag, v in n.in_specs
         if tag == "c"])
    return jmain, main


def _logits(program):
    return [n for n in program.nodes if n.op_name == "linear"][-1].out_vars[0]


def test_static_bert_inference_model_matches_paddle_tpu(static_mode,
                                                        tmp_path):
    jmain, main = _static_bert_pair(batch=4)
    ids = np.random.RandomState(7).randint(0, BERT["vocab"],
                                           (4, BERT["seq"])).astype("int64")
    outs = []
    for paddle, prog in zip(SIDES, (jmain, main)):
        path = str(tmp_path / paddle.__name__)
        paddle.static.save_inference_model(
            path, [prog.feed_vars["ids"] if hasattr(prog, "feed_vars")
                   else prog.global_block().var("ids")], [_logits(prog)],
            program=prog)
        exe = paddle.static.Executor()
        loaded, feeds, fetches = paddle.static.load_inference_model(path, exe)
        assert feeds == ["ids"]
        out, = exe.run(loaded, feed={"ids": ids}, fetch_list=fetches)
        outs.append(np.asarray(out))
    assert outs[1].shape == (4, BERT["seq"], BERT["vocab"])
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    meta, program = read_artifact(str(tmp_path / "paddle_tpu_torch"))
    layers = BERT["layers"]
    assert meta["kernels"] == {FLASH: layers, EPILOGUE: 3 * layers}
    targets = _targets(program)
    assert targets.count(
        "paddle_tpu_torch.fused_linear_epilogue_fwd.default") == 3 * layers
    assert not [t for t in targets if "softmax" in t or "gelu" in t
                or "layer_norm" in t]


def test_artifact_loads_in_a_fresh_process(cpu, tmp_path):
    """The layer's class is local to this test, so the fresh process
    cannot import it: the artifact alone carries the program."""
    jm, tm = _bert_pair()

    class LocalBert(paddle_tpu_torch.nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, ids):
            return self.inner(ids) * 2.0

    local = LocalBert(tm)
    local.eval()
    path = str(tmp_path / "bert")
    paddle_tpu_torch.jit.save(local, path, input_spec=[
        paddle_tpu_torch.jit.InputSpec([None, BERT["seq"]], "int64")])
    ids = np.random.RandomState(8).randint(0, BERT["vocab"],
                                           (3, BERT["seq"])).astype("int64")
    np.save(str(tmp_path / "ids.npy"), ids)
    code = (
        "import sys, json, numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        f"layer = paddle.jit.load({path!r})\n"
        f"out = layer(np.load({str(tmp_path / 'ids.npy')!r})).numpy()\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out)\n"
        "print(json.dumps({'jax': 'jax' in sys.modules, 'paddle_tpu': "
        "'paddle_tpu' in sys.modules}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    seen = json.loads(res.stdout.strip().splitlines()[-1])
    assert seen == {"jax": False, "paddle_tpu": False}
    got = np.load(str(tmp_path / "out.npy"))
    np.testing.assert_allclose(got, local(torch.from_numpy(ids)).detach()
                               .numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(got, 2.0 * _np(jm(paddle_tpu.to_tensor(ids))),
                               **TOL)


def test_a_paddle_tpu_artifact_is_refused_naming_both_formats(cpu,
                                                              tmp_path):
    jm, _ = _mlp_pair()
    path = str(tmp_path / "jax")
    paddle_tpu.jit.save(jm, path,
                        input_spec=[paddle_tpu.jit.InputSpec([None, 4])])
    with pytest.raises(ValueError, match="paddle_tpu.stablehlo.v1") as e:
        paddle_tpu_torch.jit.load(path)
    assert "paddle_tpu_torch.export.v1" in str(e.value)
    with pytest.raises(ValueError, match="paddle_tpu.stablehlo.v1"):
        paddle_tpu_torch.inference.create_predictor(
            paddle_tpu_torch.inference.Config(path + SUFFIX_MODEL))


def test_a_fixed_dynamic_dim_is_refused(cpu, tmp_path):
    class Fixed(paddle_tpu_torch.nn.Layer):
        def forward(self, x):
            return torch.Tensor.reshape(x, (2, 4)) * 2.0

    with pytest.raises(ValueError, match="dim 0 of input 0"):
        paddle_tpu_torch.jit.save(Fixed(), str(tmp_path / "f"), input_spec=[
            paddle_tpu_torch.jit.InputSpec([None, 4])])
    assert not os.path.exists(str(tmp_path / "f") + SUFFIX_MODEL)


def test_an_unconverted_tensor_if_is_refused(cpu, tmp_path):
    def f(x):
        out = []
        if x.sum() > 0:        # branches assign different names
            y = x * 2
        else:
            out.append(x)
        return x

    with pytest.raises(TypeError, match="paddle.cond"):
        paddle_tpu_torch.jit.save(f, str(tmp_path / "f"), input_spec=[
            paddle_tpu_torch.jit.InputSpec([None])])


def test_batch_norm_statistics_and_mode_at_save_time(cpu, tmp_path):
    x = (np.random.RandomState(9).standard_normal((16, 4)) * 2
         + 3).astype("float32")
    models = []
    for paddle in SIDES:
        models.append(paddle.nn.Sequential(paddle.nn.Linear(4, 4),
                                           paddle.nn.BatchNorm1D(4)))
    _carry(*models)
    outs = []
    for paddle, m in zip(SIDES, models):
        m.train()
        m(paddle.to_tensor(x))            # one step of running statistics
        path = str(tmp_path / paddle.__name__)
        paddle.jit.save(m, path, input_spec=[paddle.jit.InputSpec([None, 4])])
        assert m.training
        loaded = paddle.jit.load(path)
        m.eval()
        want = _np(m(paddle.to_tensor(x[:5])))
        np.testing.assert_allclose(_np(loaded(paddle.to_tensor(x[:5]))),
                                   want, rtol=1e-5, atol=1e-6)
        state = loaded.state_dict()
        np.testing.assert_allclose(_np(state["1._mean"]), _np(m[1]._mean))
        outs.append(want)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_load_places_the_program(tmp_path):
    prev = placement.default()
    try:
        paddle_tpu_torch.set_device("cpu")
        m = paddle_tpu_torch.nn.Linear(4, 2)
        path = str(tmp_path / "m")
        paddle_tpu_torch.jit.save(m, path, input_spec=[
            paddle_tpu_torch.jit.InputSpec([None, 4])])
        assert paddle_tpu_torch.jit.load(path).device.type == "cpu"
        assert paddle_tpu_torch.jit.load(path, device="cpu").device.type \
            == "cpu"
        placement.set_default(None)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                paddle_tpu_torch.jit.load(path)
    finally:
        placement.set_default(prev)


def test_a_loop_torch_cannot_export_is_refused(cpu, tmp_path, monkeypatch):
    """Where torch cannot export a ``while_loop``, ``jit.save`` raises
    naming it (fault C10) and writes nothing: never a graph with the
    example's trip count."""
    import torch._higher_order_ops.while_loop  # noqa: F401
    hop = sys.modules["torch._higher_order_ops.while_loop"]

    def refuse(*a, **k):
        raise RuntimeError("while_loop is not supported here")

    monkeypatch.setattr(hop, "while_loop", refuse)

    @paddle_tpu_torch.jit.to_static
    def f(x):
        s = x * 0
        while s.sum() < 10:
            s = s + x
        return s

    with pytest.raises(NotImplementedError, match="while_loop"):
        paddle_tpu_torch.jit.save(f, str(tmp_path / "f"), input_spec=[
            paddle_tpu_torch.jit.InputSpec([2])])
    assert not os.path.exists(str(tmp_path / "f") + SUFFIX_MODEL)
