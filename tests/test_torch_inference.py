"""paddle_tpu_torch's inference Predictor held to paddle_tpu's on the CPU.

- The 5 cases of ``tests/test_inference.py`` on both packages: the
  dygraph round trip through the handle API, no new variant across
  same-shape calls and one for a new shape, a declared bucket prepared
  at load, a static program served, and the error for an input that was
  never staged;
- ``jit.save`` -> ``create_predictor`` -> ``run`` and
  ``static.save_inference_model`` -> ``create_predictor`` -> ``run``
  for LeNet, the bench_serving MLP (64-128-128-32) and a small BERT, at
  batches other than the example's, batch 1 included: outputs within
  rtol/atol 1e-5 (f32) of paddle_tpu's;
- the predictor halves of ``bench_lenet_dygraph`` (batch 1, 50 runs) and
  ``bench_serving`` (ragged batches of 1-4 under pad-to-bucket):
  ``num_compiled_variants()`` flat after warm-up and equal to
  paddle_tpu's;
- a static program's fixed batch served padded (5 rows of 8) and sliced
  back; ``batched_output_mask``; ``share_external_data`` without a copy;
  the device choice (``disable_gpu``; no GPU and no request raises).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.framework_io import (program_state_from_paddle_tpu,
                                           state_dict_from_paddle_tpu)
from paddle_tpu_torch.testing.models import build_bert_static, build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = (paddle_tpu, paddle_tpu_torch)
TOL = dict(rtol=1e-5, atol=1e-5)
BERT = dict(vocab=1000, hidden=128, layers=2, heads=2, ffn=256, seq=64)


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
    state = {k: _np(v) for k, v in jlayer.state_dict().items()}
    tlayer.load_state_dict(state_dict_from_paddle_tpu(state, "cpu",
                                                      model=tlayer))
    return tlayer


def _mlp(paddle, sizes, seed):
    paddle.seed(seed)
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        layers += [paddle.nn.Linear(a, b), paddle.nn.ReLU()]
    return paddle.nn.Sequential(*layers[:-1])


def _saved_pair(tmp_path, make, spec, dtype="float32"):
    """Each package's model (the port's with the JAX weights) saved with
    ``InputSpec(spec, dtype)``; returns (jax prefix, port prefix, jax
    model)."""
    jm, tm = make(paddle_tpu), make(paddle_tpu_torch)
    _carry(jm, tm)
    prefixes = []
    for paddle, m in zip(SIDES, (jm, tm)):
        m.eval()
        prefix = str(tmp_path / paddle.__name__ / "m")
        paddle.jit.save(m, prefix,
                        input_spec=[paddle.jit.InputSpec(spec, dtype)])
        prefixes.append(prefix)
    return prefixes[0], prefixes[1], jm


def _predictors(jpre, tpre, configure=None):
    preds = []
    for paddle, pre in zip(SIDES, (jpre, tpre)):
        cfg = paddle.inference.Config(pre)
        if configure is not None:
            configure(cfg)
        preds.append(paddle.inference.create_predictor(cfg))
    return preds


def _dygraph_pair(tmp_path):
    """``tests/test_inference.py``'s ``_save_dygraph_model``."""
    return _saved_pair(tmp_path, lambda p: _mlp(p, (4, 8, 2), 0), [None, 4])


# --------------------------------------- tests/test_inference.py's cases --
def test_predictor_roundtrip_dygraph(cpu, tmp_path):
    jpre, tpre, jm = _dygraph_pair(tmp_path)
    x = np.random.RandomState(1).standard_normal((5, 4)).astype(np.float32)
    want = jm(paddle_tpu.to_tensor(x)).numpy()
    got = []
    for pred in _predictors(jpre, tpre):
        names = pred.get_input_names()
        pred.get_input_handle(names[0]).copy_from_cpu(x)
        pred.run()
        out = pred.get_output_handle(pred.get_output_names()[0])
        got.append(out.copy_to_cpu())
        assert isinstance(got[-1], np.ndarray)
        assert out.shape() == [5, 2]
    np.testing.assert_allclose(got[0], want, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(got[1], got[0], **TOL)


def test_predictor_zero_recompiles_across_calls(cpu, tmp_path):
    counts = []
    for pred in _predictors(*_dygraph_pair(tmp_path)[:2]):
        x = np.ones((3, 4), np.float32)
        pred.run([x])
        n0 = pred.num_compiled_variants()
        for _ in range(5):
            pred.run([x + 1.0])
        assert pred.num_compiled_variants() == n0
        pred.run([np.ones((7, 4), np.float32)])
        assert pred.num_compiled_variants() == n0 + 1
        counts.append(n0)
    assert counts[0] == counts[1]


def test_predictor_shape_bucket_aot(cpu, tmp_path):
    counts = []
    for pred in _predictors(*_dygraph_pair(tmp_path)[:2],
                            lambda cfg: cfg.add_shape_bucket((16, 4))):
        n0 = pred.num_compiled_variants()
        assert n0 >= 1
        pred.run([np.zeros((16, 4), np.float32)])
        assert pred.num_compiled_variants() == n0
        counts.append(n0)
    assert counts[0] == counts[1]


@pytest.fixture
def static_mode(cpu):
    yield
    set_flags({"use_pallas_kernels": True})
    for paddle in SIDES:
        paddle.disable_static()
        paddle.static.reset_default_programs()


def _fc_program(paddle, arr, weights=None):
    paddle.enable_static()
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [None, 6], "float32")
        out = paddle.static.nn.fc(x, 3, activation="relu")
    if weights is not None:
        program_state_from_paddle_tpu(main, weights)
    exe = paddle.static.Executor()
    want, = exe.run(main, feed={"x": arr}, fetch_list=[out])
    return main, x, out, exe, np.asarray(want)


def test_predictor_from_static_program(static_mode, tmp_path):
    arr = np.random.RandomState(2).standard_normal((4, 6)).astype(np.float32)
    jmain, jx, jout, jexe, jwant = _fc_program(paddle_tpu, arr)
    jw = [np.asarray(p.data) for p in jmain.parameters()]
    tmain, tx, tout, texe, twant = _fc_program(paddle_tpu_torch, arr, jw)
    np.testing.assert_allclose(twant, jwant, **TOL)
    got = []
    for paddle, args in zip(SIDES, ((jx, jout, jexe), (tx, tout, texe))):
        prefix = str(tmp_path / paddle.__name__ / "st")
        paddle.static.save_inference_model(prefix, [args[0]], [args[1]],
                                           args[2])
        paddle.disable_static()
        pred = paddle.inference.create_predictor(
            paddle.inference.Config(prefix))
        assert pred.get_input_names() == ["x"]
        out, = pred.run([arr])
        got.append(np.asarray(out))
        for b in (1, 3):         # batches other than the example's
            np.testing.assert_allclose(np.asarray(pred.run([arr[:b]])[0]),
                                       jwant[:b], **TOL)
        assert pred.batched_output_mask() == [True]
    np.testing.assert_allclose(got[0], jwant, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(got[1], got[0], **TOL)


def test_predictor_missing_input_error(cpu, tmp_path):
    for pred in _predictors(*_dygraph_pair(tmp_path)[:2]):
        with pytest.raises(ValueError, match="not staged"):
            pred.run()


# ---------------------------------------------------- models and benches --
@pytest.mark.parametrize("model", ["lenet", "mlp", "bert"])
def test_saved_model_served_like_paddle_tpu(cpu, tmp_path, model):
    """The port's artifact has a dynamic batch; paddle_tpu's BERT cannot
    be exported with one (its attention reshape reads the batch as an
    int), so paddle_tpu's reference for BERT is its eager forward."""
    r = np.random.RandomState(3)
    if model == "lenet":
        make, spec, dtype = (lambda p: p.vision.models.LeNet(),
                             [None, 1, 28, 28], "float32")
    elif model == "mlp":
        make, spec, dtype = (lambda p: _mlp(p, (64, 128, 128, 32), 2024),
                             [None, 64], "float32")
    else:
        make, spec, dtype = None, [None, BERT["seq"]], "int64"
    if make is not None:
        jpre, tpre, jm = _saved_pair(tmp_path, make, spec, dtype)
        jpred, tpred = _predictors(jpre, tpre)
    else:
        jm = _bench().build_model(**BERT, dropout=0.0)
        tm = _carry(jm, build_model(**BERT, dropout=0.0, device="cpu"))
        jm.eval()
        tm.eval()
        tpre = str(tmp_path / "bert")
        paddle_tpu_torch.jit.save(tm, tpre, input_spec=[
            paddle_tpu_torch.jit.InputSpec(spec, dtype)])
        jpred = None
        tpred = paddle_tpu_torch.inference.create_predictor(
            paddle_tpu_torch.inference.Config(tpre))
    for b in (1, 3, 4):
        shape = [b] + spec[1:]
        x = (r.randint(0, BERT["vocab"], shape).astype(dtype)
             if dtype == "int64" else r.standard_normal(shape).astype(dtype))
        want = (np.asarray(jpred.run([x])[0]) if jpred is not None
                else _np(jm(paddle_tpu.to_tensor(x))))
        got = tpred.run([x])[0]
        assert isinstance(got, paddle_tpu_torch.Tensor)
        assert got.shape == list(want.shape)
        np.testing.assert_allclose(np.asarray(got), want, **TOL)


def test_lenet_predictor_bench_half(cpu, tmp_path):
    """``bench_lenet_dygraph``'s predictor half (bench.py:1310-1326):
    LeNet saved with ``InputSpec([None, 1, 28, 28])``, one warm-up run,
    then 50 runs at batch 1; ``predictor_recompiles`` is
    ``num_compiled_variants()``."""
    jpre, tpre, _ = _saved_pair(tmp_path,
                                lambda p: p.vision.models.LeNet(),
                                [None, 1, 28, 28])
    xi = np.zeros((1, 1, 28, 28), "float32")
    out, variants = [], []
    for pred in _predictors(jpre, tpre):
        pred.run([xi])
        for _ in range(50):
            outs = pred.run([xi])
        out.append(float(np.asarray(outs[0]).sum()))
        variants.append(pred.num_compiled_variants())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5)
    assert variants[0] == variants[1] == 1


def test_serving_sequential_half_pads_to_buckets(cpu, tmp_path):
    """``bench_serving``'s sequential half (bench.py:817-863): the
    64-128-128-32 MLP on ragged requests of 1-4 rows through
    ``Predictor.run``; after warming every size, no new variant."""
    jpre, tpre, jm = _saved_pair(
        tmp_path, lambda p: _mlp(p, (64, 128, 128, 32), 2024), [None, 64])
    rng = np.random.RandomState(0)
    reqs = [rng.standard_normal((int(rng.randint(1, 5)), 64))
            .astype(np.float32) for _ in range(40)]
    counts = []
    for pred in _predictors(jpre, tpre):
        for n in sorted({r.shape[0] for r in reqs}):
            np.asarray(pred.run([np.zeros((n, 64), np.float32)])[0])
        warm = pred.num_compiled_variants()
        outs = [np.asarray(pred.run([r])[0]) for r in reqs]
        assert pred.num_compiled_variants() == warm
        for r, o in zip(reqs, outs):
            assert o.shape == (r.shape[0], 32)
            np.testing.assert_allclose(o, jm(paddle_tpu.to_tensor(r))
                                       .numpy(), **TOL)
        counts.append(warm)
    assert counts[0] == counts[1] == 3         # buckets 1, 2 and 4


def test_static_bert_predictor_pads_to_the_program_batch(cpu, static_mode,
                                                         tmp_path):
    """The static BERT's batch is fixed at 8: 5 rows are padded to 8 and
    the logits sliced back, on both packages."""
    c = dict(BERT, batch=8)
    for paddle in SIDES:
        paddle.enable_static()
    paddle_tpu.core.flags.set_flags({"pallas_interpret": True})
    try:
        jmain, _, _ = _bench().build_bert_static(**c)
        main, _, _ = build_bert_static(**c, device="cpu")
    finally:
        paddle_tpu.core.flags.set_flags({"pallas_interpret": False})
    program_state_from_paddle_tpu(
        main, [np.asarray(p.data) for p in jmain.parameters()],
        [np.asarray(v) for n in jmain.nodes for tag, v in n.in_specs
         if tag == "c"])
    prefixes = []
    for paddle, prog in zip(SIDES, (jmain, main)):
        logits = [n for n in prog.nodes
                  if n.op_name == "linear"][-1].out_vars[0]
        prefix = str(tmp_path / paddle.__name__ / "sb")
        paddle.static.save_inference_model(prefix, [prog.feed_vars["ids"]],
                                           [logits], program=prog)
        prefixes.append(prefix)
        paddle.disable_static()
    ids = np.random.RandomState(4).randint(0, c["vocab"],
                                           (5, c["seq"])).astype("int64")
    got = []
    for pred in _predictors(*prefixes):
        assert pred.num_compiled_variants() == 1
        out = np.asarray(pred.run([ids])[0])
        assert out.shape == (5, c["seq"], c["vocab"])
        assert pred.num_compiled_variants() == 1
        got.append(out)
    np.testing.assert_allclose(got[1], got[0], **TOL)
    assert _predictors(*prefixes)[1].batched_output_mask() is None


def test_share_external_data_and_handles(cpu, tmp_path):
    _, tpre, jm = _dygraph_pair(tmp_path)
    pred = paddle_tpu_torch.inference.create_predictor(
        paddle_tpu_torch.inference.Config(tpre))
    x = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (3, 4)).astype(np.float32))
    h = pred.get_input_handle("x0")
    h.share_external_data(x)
    assert pred._inputs["x0"] is x               # staged without a copy
    assert h.shape() == [3, 4]
    out, = pred.run()
    assert out.device.type == "cpu"
    np.testing.assert_allclose(
        pred.get_output_handle("out0").copy_to_cpu(),
        jm(paddle_tpu.to_tensor(x.numpy())).numpy(), **TOL)


def test_predictor_device_choice(tmp_path):
    prev = placement.default()
    try:
        paddle_tpu_torch.set_device("cpu")
        _, tpre, _ = _dygraph_pair(tmp_path)
        placement.set_default(None)
        cfg = paddle_tpu_torch.inference.Config(tpre)
        cfg.disable_gpu()
        assert paddle_tpu_torch.inference.create_predictor(
            cfg).device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                paddle_tpu_torch.inference.create_predictor(
                    paddle_tpu_torch.inference.Config(tpre))
            cfg = paddle_tpu_torch.inference.Config(tpre)
            cfg.enable_use_gpu()
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle_tpu_torch.inference.create_predictor(cfg)
    finally:
        placement.set_default(prev)


def test_another_params_file_serves_its_weights(cpu, tmp_path):
    """The weights are not baked into the program: ``Config(prog,
    params)`` serves another ``.pdiparams`` with the same names (the
    reference's split of program and parameter files)."""
    a = _mlp(paddle_tpu_torch, (4, 8, 2), 0)
    b = _mlp(paddle_tpu_torch, (4, 8, 2), 1)
    for name, m in (("a", a), ("b", b)):
        m.eval()
        paddle_tpu_torch.jit.save(m, str(tmp_path / name), input_spec=[
            paddle_tpu_torch.jit.InputSpec([None, 4])])
    pred = paddle_tpu_torch.inference.create_predictor(
        paddle_tpu_torch.inference.Config(
            str(tmp_path / "a.pdmodel"), str(tmp_path / "b.pdiparams")))
    x = np.ones((2, 4), np.float32)
    np.testing.assert_allclose(np.asarray(pred.run([x])[0]),
                               b(paddle_tpu_torch.to_tensor(x)).numpy(),
                               rtol=0, atol=0)
