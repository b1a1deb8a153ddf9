"""The rest of the static path held to paddle_tpu's: ``bench_pallas``'s
static GPT and ``bench_static``'s two programs.

- ``build_gpt_static`` at bench_pallas's CPU widths (bench.py:1116;
  vocab 1000, hidden 128, 2 layers, 4 heads, ffn 512, seq 128, batch 4),
  tier on, from the JAX program's weights and constant: the same
  realized kernel list, 3 losses within 1e-5 relative (f32 sums in
  other orders), the parameters within 2e-5 but the key projections'
  biases, whose gradient is zero but for rounding (Adam moves them by up
  to lr a step);
- bench_static's MLP (hidden 128, depth 8, batch 32) and LeNet (batch
  16) at its CPU config (bench.py:633-639) from carried weights: 3
  losses within 1e-5 relative for the MLP, 1e-4 for the LeNet (its
  convolutions sum in another order), and the same realized kernels;
- ``compile_count`` and ``host_feed_converts`` as
  ``tests/test_static_fastpath.py`` holds paddle_tpu's: one build per
  feed signature, no conversion for feeds already on the Executor's
  device, one for each other feed;
- ``static.nn.batch_norm`` against paddle_tpu's, in a forward program
  and in 3 training runs.

JAX runs with the tier on and ``pallas_interpret`` set, as paddle_tpu's
own Executor tests run it on the CPU.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu_torch import optimizer, static
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import program_state_from_paddle_tpu
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.testing.models import (build_gpt_static,
                                             build_static_lenet,
                                             build_static_mlp)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT_CPU = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512, seq=128,
               batch=4)
# per layer fc1 + gelu and the residual adds after proj and fc2; the last
# fc2's add feeds only the final layer norm, so its chain takes it too
GPT_KERNELS = (["fused_epilogue[matmul+bias+gelu]"] * 2
               + ["fused_epilogue[matmul+bias+add+layer_norm]"]
               + ["fused_epilogue[matmul+bias+add]"] * 3 + ["fused_adam"])


@pytest.fixture(autouse=True)
def both_static():
    prev = placement.default()
    pt.set_device("cpu")
    pt.enable_static()
    paddle.enable_static()
    paddle.set_flags({"pallas_interpret": True, "use_pallas_kernels": True})
    yield
    paddle.set_flags({"pallas_interpret": False})
    paddle.disable_static()
    paddle.static.reset_default_programs()
    pt.disable_static()
    placement.set_default(prev)


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(exe):
    (step,) = exe._cache.values()
    return step.kernels


def _jax_kernels(program):
    recs = [r for r in paddle.observability.explain_compiles(
        "executor")["records"] if r["identity"] == program._serial]
    return recs[-1]["kernels"]


def _runs(exe, program, loss, feed, n):
    return [float(exe.run(program, feed=feed, fetch_list=[loss])[0])
            for _ in range(n)]


def _carry(jmain, main):
    """The JAX program's parameters and constants into the port's."""
    program_state_from_paddle_tpu(
        main, [np.asarray(p.data) for p in jmain.parameters()],
        [np.asarray(v) for node in jmain.nodes
         for tag, v in node.in_specs if tag == "c"])


def test_static_gpt_matches_paddle_tpu():
    c, runs, lr = GPT_CPU, 3, 1e-4
    jmain, jloss, jfeeds = _bench().build_gpt_static(**c)
    jparams = [np.asarray(p.data) for p in jmain.parameters()]
    main, loss, _ = build_gpt_static(**c, device="cpu")
    assert len(main.parameters()) == len(jparams) == 1 + 16 * c["layers"] + 4
    _carry(jmain, main)
    feed = jfeeds(np.random.RandomState(0))
    jexe = paddle.static.Executor()
    jl = _runs(jexe, jmain, jloss, feed, runs)
    jkernels = _jax_kernels(jmain)
    jafter = [np.asarray(p.data) for p in jmain.parameters()]
    jexe.close()
    exe = static.Executor()
    tl = _runs(exe, main, loss, {k: np.asarray(v) for k, v in feed.items()},
               runs)
    assert _kernels(exe) == jkernels == GPT_KERNELS
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    # the token table, then per layer ln1, wq, wk, wv, proj, ln2, fc1 and
    # fc2 (weight and bias each): wk's bias is the layer's sixth
    k_bias = {1 + 16 * layer + 5 for layer in range(c["layers"])}
    for i, (p, j, j0) in enumerate(zip(main.parameters(), jafter, jparams)):
        t = p.detach().numpy()
        if i in k_bias:
            assert np.abs(t - j0).max() <= runs * lr * 1.01
            assert np.abs(j - j0).max() <= runs * lr * 1.01
            continue
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-5, err_msg=str(i))


def _jax_mlp(hidden, depth):
    """bench_static's ``build_mlp`` (bench.py:640-652)."""
    paddle.seed(7)
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [None, hidden], "float32")
        y = paddle.static.data("y", [None, 1], "float32")
        h = x
        for _ in range(depth):
            h = paddle.static.nn.fc(h, hidden, activation="relu")
        loss = JF.mse_loss(paddle.static.nn.fc(h, 1), y)
        jopt.Adam(learning_rate=1e-3).minimize(loss)
    return main, loss


def _jax_lenet():
    """bench_static's ``build_lenet`` (bench.py:654-663)."""
    paddle.seed(9)
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [None, 1, 28, 28], "float32")
        y = paddle.static.data("y", [None], "int64")
        loss = JF.cross_entropy(JLeNet()(x), y)
        jopt.Adam(learning_rate=1e-3).minimize(loss)
    return main, loss


def _bench_static_feeds(hidden=128, batch=32, lenet_batch=16):
    """bench_static's inputs at its CPU config, drawn in its order."""
    r = np.random.RandomState(0)
    xs = r.standard_normal((batch, hidden)).astype(np.float32)
    ys = r.standard_normal((batch, 1)).astype(np.float32)
    lx = r.standard_normal((lenet_batch, 1, 28, 28)).astype(np.float32)
    ly = r.randint(0, 10, (lenet_batch,), dtype=np.int64)
    return {"x": xs, "y": ys}, {"x": lx, "y": ly}


@pytest.mark.parametrize("name,rtol,kernels", [
    ("mlp", 1e-5, ["fused_epilogue[matmul+bias+relu]"] * 8
     + ["fused_adam"]),
    ("lenet", 1e-4, ["fused_adam"])])
def test_bench_static_programs_match_paddle_tpu(name, rtol, kernels):
    mlp_feed, lenet_feed = _bench_static_feeds()
    if name == "mlp":
        (jmain, jloss), (main, loss) = (_jax_mlp(128, 8),
                                        build_static_mlp(128, 8))
        feed = mlp_feed
    else:
        (jmain, jloss), (main, loss) = _jax_lenet(), build_static_lenet()
        feed = lenet_feed
    _carry(jmain, main)
    jexe = paddle.static.Executor()
    jl = _runs(jexe, jmain, jloss,
               {k: jnp.asarray(v) for k, v in feed.items()}, 3)
    jkernels = _jax_kernels(jmain)
    jexe.close()
    exe = static.Executor()
    tl = _runs(exe, main, loss, {k: torch.from_numpy(v)
                                 for k, v in feed.items()}, 3)
    assert _kernels(exe) == jkernels == kernels
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert exe.compile_count == 1 and exe.host_feed_converts == 0


def test_compile_count_and_host_feed_converts():
    """test_static_fastpath.py's two cases: a new batch size builds once
    more, and only feeds that are not already on the device convert."""
    def mlp():
        pt.seed(0)
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 8], "float32")
            y = static.data("y", [None, 1], "float32")
            h = static.nn.fc(x, 16, activation="relu")
            loss = F.mse_loss(static.nn.fc(h, 1), y)
            optimizer.SGD(learning_rate=0.05).minimize(loss)
        return main, loss

    def batch(n=16):
        r = np.random.RandomState(0)
        xs = r.standard_normal((n, 8)).astype(np.float32)
        return xs, (xs @ r.standard_normal((8, 1))).astype(np.float32)

    main, loss = mlp()
    exe = static.Executor()
    for bs in (16, 16, 4, 4, 16):
        xs, ys = batch(bs)
        exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
    assert exe.compile_count == 2
    main, loss = mlp()
    exe = static.Executor()
    xs, ys = batch()
    dev = {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}
    for _ in range(5):
        exe.run(main, feed=dev, fetch_list=[loss], return_numpy=False)
    assert exe.host_feed_converts == 0
    exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
    assert exe.host_feed_converts == 2
    assert exe.compile_count == 1


def _bn_programs(side_static, F_, opt_mod, train):
    main = side_static.Program()
    with side_static.program_guard(main):
        x = side_static.data("x", [8, 4, 3, 3], "float32")
        h = side_static.nn.batch_norm(x)
        out = h
        if train:
            y = side_static.data("y", [8, 1], "float32")
            out = F_.mse_loss(side_static.nn.fc(h, 1), y)
            opt_mod.Adam(learning_rate=1e-2).minimize(out)
    return main, out


@pytest.mark.parametrize("train", [False, True])
def test_static_batch_norm_matches(train):
    r = np.random.RandomState(5)
    feed = {"x": (r.standard_normal((8, 4, 3, 3)) * 2 + 1).astype(np.float32)}
    if train:
        feed["y"] = r.standard_normal((8, 1)).astype(np.float32)
    paddle.seed(1)
    jmain, jout = _bn_programs(paddle.static, JF, jopt, train)
    main, out = _bn_programs(static, F, optimizer, train)
    assert [n.op_name for n in main.nodes] == [n.op_name for n in jmain.nodes]
    _carry(jmain, main)
    jexe, exe = paddle.static.Executor(), static.Executor()
    n = 3 if train else 1
    jr = [np.asarray(jexe.run(jmain, feed={k: jnp.asarray(v) for k, v in
                                           feed.items()},
                              fetch_list=[jout])[0]) for _ in range(n)]
    tr = [exe.run(main, feed=feed, fetch_list=[out])[0] for _ in range(n)]
    np.testing.assert_allclose(np.stack(tr), np.stack(jr), rtol=1e-5,
                               atol=1e-6)
    jexe.close()
