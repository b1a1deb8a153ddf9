"""paddle_tpu_torch's static graph held to paddle_tpu's.

- paddle_tpu's Executor tests, ported: a small ``fc`` program realizes
  the fused epilogue and fused Adam and builds once; with
  ``FLAGS_use_pallas_kernels`` off it selects nothing and is bitwise
  reproducible; on and off agree; a width the gate refuses stays on the
  composite; and the same program trains as paddle_tpu's does from the
  same weights.
- ``bench.build_bert_static`` at bench_pallas's CPU widths (bench.py:
  1114): the port's program, loaded with the JAX program's weights,
  realizes the same kernel list, matches the 4 losses within 1e-5
  relative and the parameters after the steps.
- The pass raises instead of quietly running the composite; the
  Executor's place, fetch and trainable-set contracts.

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
import paddle_tpu_torch as pt
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu_torch import optimizer, static
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.framework_io import program_state_from_paddle_tpu
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.static.analysis import fusion
from paddle_tpu_torch.testing.models import build_bert_static

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT_CPU = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512,
                seq=128, batch=8)
JAX_BERT_KERNELS = (["fused_epilogue[matmul+bias+gelu]"] * 2
                    + ["fused_epilogue[matmul+bias+add+layer_norm]"] * 4
                    + ["fused_adam"])


@pytest.fixture
def cpu_device():
    """``set_device("cpu")`` for the test, the default restored after."""
    prev = placement.default()
    pt.set_device("cpu")
    pt.enable_static()
    yield
    pt.disable_static()
    set_flags({"use_pallas_kernels": True})
    placement.set_default(prev)


@pytest.fixture
def jax_static():
    paddle.enable_static()
    jax_set_flags({"pallas_interpret": True, "use_pallas_kernels": True})
    yield
    jax_set_flags({"pallas_interpret": False, "use_pallas_kernels": True})
    paddle.disable_static()
    paddle.static.reset_default_programs()


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mini_program(width=128):
    """paddle_tpu's ``_mini_program`` (test_pallas.py), in the port."""
    pt.seed(3)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, width], "float32")
        y = static.data("y", [None, 1], "float32")
        h = static.nn.fc(x, width, activation="relu")
        loss = F.mse_loss(static.nn.fc(h, 1), y)
        optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, loss


def _feed(width, batch=16):
    r = np.random.RandomState(0)
    return {"x": r.standard_normal((batch, width)).astype(np.float32),
            "y": r.standard_normal((batch, 1)).astype(np.float32)}


def _kernels(exe):
    (step,) = exe._cache.values()
    return step.kernels


def test_executor_realizes_and_builds_once(cpu_device):
    main, loss = _mini_program()
    exe = static.Executor()
    for _ in range(3):
        out = exe.run(main, feed=_feed(128), fetch_list=[loss])
    assert np.isfinite(out[0]).all()
    assert exe.compile_count == 1
    assert _kernels(exe) == ["fused_epilogue[matmul+bias+relu]",
                             "fused_adam"]


def test_flag_off_is_bitwise_and_selects_nothing(cpu_device):
    def losses(flag):
        set_flags({"use_pallas_kernels": flag})
        main, loss = _mini_program()
        exe = static.Executor()
        out = [float(exe.run(main, feed=_feed(128), fetch_list=[loss])[0])
               for _ in range(4)]
        return out, _kernels(exe)

    off, off_kernels = losses(False)
    assert off_kernels == []
    on, on_kernels = losses(True)
    assert on_kernels
    off2, _ = losses(False)
    assert off == off2
    assert max(abs(a - b) for a, b in zip(on, off)) < 1e-4


def test_gated_out_width_stays_on_the_composite(cpu_device):
    main, loss = _mini_program(width=100)
    exe = static.Executor()
    out = exe.run(main, feed=_feed(100), fetch_list=[loss])
    assert np.isfinite(out[0]).all()
    assert _kernels(exe) == ["fused_adam"]


def test_mini_program_trains_as_paddle_tpu_does(cpu_device, jax_static):
    """The same fc program from the same weights, tier on both sides:
    3 losses within 1e-5 relative and the parameters within 1e-6."""
    import paddle_tpu.nn.functional as JF
    from paddle_tpu import optimizer as jopt
    paddle.seed(3)
    jmain = paddle.static.Program()
    with paddle.static.program_guard(jmain):
        x = paddle.static.data("x", [None, 128], "float32")
        y = paddle.static.data("y", [None, 1], "float32")
        h = paddle.static.nn.fc(x, 128, activation="relu")
        jloss = JF.mse_loss(paddle.static.nn.fc(h, 1), y)
        jopt.Adam(learning_rate=1e-3).minimize(jloss)
    main, loss = _mini_program()
    program_state_from_paddle_tpu(
        main, [np.asarray(p.data) for p in jmain.parameters()])
    jexe, exe = paddle.static.Executor(), static.Executor()
    feed = _feed(128)
    jl = [float(jexe.run(jmain, feed={k: jnp.asarray(v) for k, v in
                                      feed.items()},
                         fetch_list=[jloss])[0]) for _ in range(3)]
    tl = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for p, q in zip(main.parameters(), jmain.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q.data),
                                   rtol=0, atol=1e-6)
    jexe.close()


def test_static_bert_matches_paddle_tpu(cpu_device, jax_static):
    """bench_pallas's CPU widths, 4 runs from the JAX program's weights
    and constants: the same realized kernels; losses within 1e-5
    relative (f32 sums in other orders); parameters within 2e-5, a fifth
    of one Adam step, except the key projections' biases, whose gradient
    is zero but for rounding: Adam moves them by up to lr a step."""
    c, runs, lr = BERT_CPU, 4, 1e-4
    jmain, jloss, jfeeds = _bench().build_bert_static(**c)
    jparams = [np.asarray(p.data) for p in jmain.parameters()]
    jconsts = [np.asarray(v) for node in jmain.nodes
               for tag, v in node.in_specs if tag == "c"]
    jexe = paddle.static.Executor()
    feed = jfeeds(np.random.RandomState(0))
    jl = [float(jexe.run(jmain, feed=feed, fetch_list=[jloss])[0])
          for _ in range(runs)]
    jrec = [r for r in paddle.observability.explain_compiles(
        "executor")["records"] if r["identity"] == jmain._serial]
    jkernels = jrec[-1]["kernels"]
    jafter = [np.asarray(p.data) for p in jmain.parameters()]
    jexe.close()

    main, loss, feeds = build_bert_static(**c)
    assert len(main.parameters()) == len(jparams) == 35
    program_state_from_paddle_tpu(main, jparams, jconsts)
    exe = static.Executor()
    tfeed = {k: np.asarray(v) for k, v in feed.items()}
    tl = [float(exe.run(main, feed=tfeed, fetch_list=[loss])[0])
          for _ in range(runs)]
    assert _kernels(exe) == jkernels == JAX_BERT_KERNELS
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    k_bias = {1 + 16 * layer + 3 for layer in range(c["layers"])}
    for i, (p, j, j0) in enumerate(zip(main.parameters(), jafter,
                                       jparams)):
        t = p.detach().numpy()
        if i in k_bias:
            assert np.abs(t - j0).max() <= runs * lr * 1.01
            assert np.abs(j - j0).max() <= runs * lr * 1.01
            continue
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-5, err_msg=str(i))


def test_fusion_pass_raises_instead_of_dropping_the_chain(cpu_device,
                                                         monkeypatch):
    main, loss = _mini_program()

    def broken(*a, **k):
        raise RuntimeError("gate broke")

    monkeypatch.setattr("paddle_tpu_torch.ops.fused_epilogue."
                        "fused_epilogue_supported", broken)
    with pytest.raises(RuntimeError, match="gate broke"):
        fusion.plan_fusions(main, [loss], {"x": (16, 128), "y": (16, 1)})
    with pytest.raises(RuntimeError, match="gate broke"):
        static.Executor().run(main, feed=_feed(128), fetch_list=[loss])


def test_fetch_by_name_and_device_tensors(cpu_device):
    main, loss = _mini_program()
    exe = static.Executor()
    out = exe.run(main, feed=_feed(128), fetch_list=[loss.name],
                  return_numpy=False)
    assert isinstance(out[0], torch.Tensor) and out[0].shape == ()
    assert not out[0].requires_grad


def test_no_grad_set_and_parameters_pick_what_trains(cpu_device):
    main, loss = _mini_program()
    w1, b1, w2, b2 = main.parameters()
    main._optimizer = main._optimizer[:2] + (None, {w1})
    before = [p.detach().clone() for p in (w1, b1, w2, b2)]
    exe = static.Executor()
    exe.run(main, feed=_feed(128), fetch_list=[loss])
    assert torch.equal(w1, before[0])
    assert all(not torch.equal(p, q)
               for p, q in zip((b1, w2, b2), before[1:]))
    main2, loss2 = _mini_program()
    v1, c1, v2, c2 = main2.parameters()
    optimizer.Adam(1e-3).minimize(loss2, parameters=[v2])
    before = [p.detach().clone() for p in (v1, c1, v2, c2)]
    static.Executor().run(main2, feed=_feed(128), fetch_list=[loss2])
    assert not torch.equal(v2, before[2])
    assert all(torch.equal(p, q) for p, q in zip((v1, c1, c2),
                                                 (before[0], before[1],
                                                  before[3])))


def test_place_must_hold_the_parameters(cpu_device):
    main, loss = _mini_program()
    with pytest.raises(ValueError, match="parameter"):
        static.Executor("meta").run(main, feed=_feed(128),
                                    fetch_list=[loss])


def test_variable_sugar_and_shapes(cpu_device):
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [None, 4, 6], "float32")
        y = (x + 1.0).reshape([-1, 24]).unsqueeze(0) * 2.0
        z = 3.0 - x
    assert x.shape == [-1, 4, 6] and y.shape == [1, 1, 24]
    assert [n.op_name for n in prog.nodes] == ["add", "reshape",
                                                "unsqueeze", "multiply",
                                                "subtract"]
    with pytest.raises(TypeError, match="bool"):
        bool(x)
    feed = {"x": np.arange(48, dtype=np.float32).reshape(2, 4, 6)}
    out_y, out_z = static.Executor().run(prog, feed=feed,
                                         fetch_list=[y, z])
    np.testing.assert_array_equal(
        out_y, ((feed["x"] + 1.0).reshape(-1, 24)[None] * 2.0))
    np.testing.assert_array_equal(out_z, 3.0 - feed["x"])
    assert pt.in_dynamic_mode() is False


def test_eager_minimize_is_backward_then_step():
    """Off the static path ``minimize`` runs ``loss.backward()`` and
    ``step()``: the same update as doing both by hand."""
    torch.manual_seed(0)
    w1 = torch.nn.Parameter(torch.randn(4, 3))
    w2 = torch.nn.Parameter(w1.detach().clone())
    w0 = w1.detach().clone()
    x = torch.randn(5, 4)
    o1 = optimizer.Adam(1e-2, parameters=[w1])
    o2 = optimizer.Adam(1e-2, parameters=[w2])
    _, pairs = o1.minimize(F.mse_loss(F.linear(x, w1), torch.zeros(5, 3)))
    F.mse_loss(F.linear(x, w2), torch.zeros(5, 3)).backward()
    o2.step()
    assert pairs[0][0] is w1 and pairs[0][1] is not None
    assert torch.equal(w1, w2) and not torch.equal(w1, w0)
