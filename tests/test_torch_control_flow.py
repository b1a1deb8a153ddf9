"""cond, case, switch_case and while_loop of the port against
paddle_tpu's, on the CPU (the cases of ``tests/test_control_flow.py``):
eagerly only the chosen branch runs, differentiably; ``case``'s default
and ``switch_case``'s list, pairs and dict forms pick what paddle_tpu
picks; static programs with control flow give paddle_tpu's fetches
through ``Executor.run`` (a training program too), and ``verify`` and
``analyze`` give its diagnostics and counts.  The kept differences are
pinned: the port has no traced regime, so a Python ``if`` on a tensor
runs inside ``jit.TrainStep``, and a ``while_loop`` there has
gradients."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement

SIDES = (paddle_tpu, paddle_tpu_torch)


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


@pytest.fixture
def static(cpu):
    yield
    for pkg in SIDES:
        pkg.disable_static()
        pkg.static.reset_default_programs()


# -------------------------------------------------------------- eager --
@pytest.mark.parametrize("pred", [True, False])
def test_cond_eager_runs_single_branch(cpu, pred):
    for paddle in SIDES:
        ran = []

        def t():
            ran.append("t")
            return paddle.ones([2])

        def f():
            ran.append("f")
            return paddle.zeros([2])

        out = paddle.cond(paddle.to_tensor(pred), t, f)
        assert ran == (["t"] if pred else ["f"])
        np.testing.assert_array_equal(out.numpy(), [float(pred)] * 2)


@pytest.mark.parametrize("vals", [[2.0, 3.0], [1.0, 1.0]])
def test_cond_eager_grad_through_chosen_branch(cpu, vals):
    grads = []
    for paddle in SIDES:
        x = paddle.to_tensor(np.array(vals, np.float32),
                             stop_gradient=False)
        out = paddle.cond(x.sum() > 4.0, lambda: (x * x).sum(),
                          lambda: x.sum())
        out.backward()
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0])


@pytest.mark.parametrize("flags,want", [((False, True, True), 2.0),
                                        ((False, False, False), 9.0),
                                        ((True, False, True), 1.0)])
def test_case_eager(cpu, flags, want):
    for paddle in SIDES:
        out = paddle.case(
            [(paddle.to_tensor(f), lambda v=v: paddle.full([1], v))
             for f, v in zip(flags, (1.0, 2.0, 3.0))],
            default=lambda: paddle.full([1], 9.0))
        assert float(out) == want


def test_case_without_default_runs_the_last(cpu):
    for paddle in SIDES:
        out = paddle.case(
            [(paddle.to_tensor(False), lambda: paddle.full([1], 1.0)),
             (paddle.to_tensor(False), lambda: paddle.full([1], 2.0))])
        assert float(out) == 2.0


def _branch_forms(paddle):
    f = lambda v: (lambda: paddle.full([1], v))  # noqa: E731
    return {"list": [f(0.0), f(10.0), f(20.0)],
            "pairs": [(3, f(30.0)), (1, f(10.0))],
            "dict": {1: f(10.0), 3: f(30.0)}}


@pytest.mark.parametrize("form", ["list", "pairs", "dict"])
@pytest.mark.parametrize("index", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("with_default", [False, True])
def test_switch_case_eager(cpu, form, index, with_default):
    got = []
    for paddle in SIDES:
        d = (lambda: paddle.full([1], -1.0)) if with_default else None
        got.append(float(paddle.switch_case(
            paddle.to_tensor(index), _branch_forms(paddle)[form],
            default=d)))
    assert got[1] == got[0]


def test_while_loop_eager_differentiable(cpu):
    for paddle in SIDES:
        x = paddle.to_tensor(np.array(2.0, np.float32), stop_gradient=False)
        i = paddle.to_tensor(np.array(0, np.int32))
        _, acc = paddle.while_loop(
            lambda i, acc: int(i) < 3, lambda i, acc: (i + 1, acc * x),
            [i, paddle.ones([], dtype="float32")])
        assert float(acc) == 8.0
        acc.backward()
        np.testing.assert_allclose(float(x.grad), 12.0)


def test_while_loop_tensor_shapes_preserved(cpu):
    for paddle in SIDES:
        i, v = paddle.while_loop(lambda i, v: i < 4,
                                 lambda i, v: (i + 1, v + 1.0),
                                 [paddle.zeros([], dtype="int32"),
                                  paddle.zeros([3, 2])])
        assert v.shape == [3, 2] and int(i) == 4
        np.testing.assert_allclose(v.numpy(), np.full((3, 2), 4.0))


# ------------------------------------------------------------- static --
EOS, MAXLEN = 0, 8


def _decode_program(paddle):
    """test_control_flow.py's dynamic decode as a static program (its
    start token derived from a feed, so the loop is a node), and a cond
    on a feed's sum."""
    paddle.enable_static()
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        seed = paddle.static.data("seed", [], "int64")
        x = paddle.static.data("x", [None, 4], "float32")

        def cond(t, tok, out):
            return paddle.logical_and(t < MAXLEN,
                                      paddle.logical_not(tok == EOS))

        def body(t, tok, out):
            nxt = paddle.mod(tok * 3 + seed, paddle.full([], 5,
                                                         dtype="int64"))
            out = paddle.scatter(out, t.reshape([1]),
                                 nxt.reshape([1, 1]).astype("float32"))
            return t + 1, nxt, out

        t, _, out = paddle.static.nn.while_loop(
            cond, body, [paddle.zeros([], dtype="int64"), seed * 0 + 3,
                         paddle.full([MAXLEN, 1], -1.0)])
        y = paddle.static.nn.cond(x.sum() > 0, lambda: x * 2,
                                  lambda: x - 1)
    paddle.disable_static()
    return main, [t, out, y]


@pytest.mark.parametrize("seed,rows", [(1, 2), (2, 3), (4, 1)])
def test_static_while_loop_and_cond_fetches(static, seed, rows):
    """The decode's step count and buffer and the cond's output equal
    paddle_tpu's, run after run of one Executor."""
    got = []
    for paddle in SIDES:
        main, fetch = _decode_program(paddle)
        exe = paddle.static.Executor()
        runs = []
        for sign in (1.0, -1.0):
            feed = {"seed": np.array(seed, np.int64),
                    "x": sign * np.ones((rows, 4), np.float32)}
            runs.append(exe.run(main, feed=feed, fetch_list=fetch))
        got.append(runs)
        assert [n.op_name for n in main.nodes][-4:] == (
            ["while_loop", "sum", "greater", "cond"] if paddle is paddle_tpu
            else ["while_loop", "sum", "greater_than", "cond"])
    for a, b in zip(got[0], got[1]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(np.asarray(v), np.asarray(u))


def _case_switch_program(paddle):
    paddle.enable_static()
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [1], "float32")
        i = paddle.static.data("i", [], "int64")
        s = x.sum()
        c = paddle.static.nn.case([(s < 0, lambda: x - 10),
                                   (s < 10, lambda: x * 2)],
                                  default=lambda: x + 100)
        w = paddle.static.nn.switch_case(
            i, {1: lambda: x * 10.0, 3: lambda: x * 30.0},
            default=lambda: x * -1.0)
    paddle.disable_static()
    return main, [c, w]


@pytest.mark.parametrize("xv,iv", [(-5.0, 1), (3.0, 3), (50.0, 2)])
def test_static_case_and_switch_case(static, xv, iv):
    got = []
    for paddle in SIDES:
        main, fetch = _case_switch_program(paddle)
        got.append(paddle.static.Executor().run(
            main, feed={"x": np.array([xv], np.float32),
                        "i": np.array(iv, np.int64)}, fetch_list=fetch))
    for u, v in zip(*got):
        np.testing.assert_array_equal(np.asarray(v), np.asarray(u))


def test_static_while_whose_cond_closes_over_a_variable(static):
    """paddle_tpu's control_flow.py:236-240 case: the loop variables are
    eager and ``cond`` reads a Variable, so the loop is a node."""
    got = []
    for paddle in SIDES:
        paddle.enable_static()
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            n = paddle.static.data("n", [], "int64")
            i, acc = paddle.static.nn.while_loop(
                lambda i, acc: i < n, lambda i, acc: (i + 1, acc * 2.0),
                [paddle.zeros([], dtype="int64"),
                 paddle.ones([], dtype="float32")])
        paddle.disable_static()
        assert main.nodes[-1].op_name == "while_loop"
        exe = paddle.static.Executor()
        got.append([exe.run(main, feed={"n": np.array(k, np.int64)},
                            fetch_list=[i, acc]) for k in (0, 3, 5)])
    for a, b in zip(*got):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(np.asarray(v), np.asarray(u))


def _train_program(paddle, w1, w2):
    """x -> fc -> cond(sum > 0: a second Linear, else: * 2) -> mse,
    trained by SGD: the second Linear's weights are read only inside a
    branch."""
    paddle.enable_static()
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [None, 4], "float32")
        y = paddle.static.data("y", [None, 3], "float32")
        l1 = paddle.nn.Linear(4, 3)
        l2 = paddle.nn.Linear(3, 3)
        l1.weight.set_value(w1)
        l2.weight.set_value(w2)
        h = l1(x)
        out = paddle.static.nn.cond(h.sum() > 0, lambda: l2(h),
                                    lambda: h * 2.0)
        loss = paddle.nn.functional.mse_loss(out, y)
        paddle.optimizer.SGD(learning_rate=0.1).minimize(loss)
    paddle.disable_static()
    return main, loss, l1, l2


def test_static_training_through_cond(static):
    """Three SGD runs of a program whose cond takes both branches: the
    losses and both Linears' weights equal paddle_tpu's (the branch's
    parameters are the program's, trained at their current values)."""
    rs = np.random.RandomState(0)
    w1, w2 = (rs.randn(4, 3).astype("float32"),
              rs.randn(3, 3).astype("float32"))
    xs = [rs.randn(5, 4).astype("float32") * s for s in (3, -3, 3)]
    ys = [rs.randn(5, 3).astype("float32") for _ in xs]
    got = []
    for paddle in SIDES:
        main, loss, l1, l2 = _train_program(paddle, w1, w2)
        assert len(main.parameters()) == 4
        exe = paddle.static.Executor()
        losses = [float(np.asarray(exe.run(main, feed={"x": x, "y": y},
                                           fetch_list=[loss])[0]))
                  for x, y in zip(xs, ys)]
        got.append([losses, l1.weight.numpy(), l2.weight.numpy()])
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-5)
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1][2], got[0][2], rtol=1e-5, atol=1e-6)
    assert not np.allclose(got[1][2], w2)


def _codes(diags):
    return sorted((d.pass_name, d.severity) for d in diags)


def test_verify_and_analyze_count_control_flow(static):
    """``verify`` gives paddle_tpu's diagnostics (the two captured
    constants of the loop; paddle_tpu adds its int64 info, which the
    port has no counterpart for), and ``analyze`` counts the
    control-flow nodes as paddle_tpu's cost model does: unmodeled (the
    rest differs by the comparison's name: paddle_tpu records ``>`` as
    ``greater``, which its own table does not price)."""
    got = {}
    for paddle in SIDES:
        main, fetch = _decode_program(paddle)
        diags = [d for d in main.verify(fetch_list=fetch,
                                        raise_on_error=False)
                 if d.pass_name != "wide-dtype"]
        rep = main.analyze(fetch_list=fetch, batch_size=4).to_dict()
        ops = [(c["op_name"], c["rule"], c["flops"], c["modeled"])
               for c in rep["per_op"]
               if c["op_name"] in ("while_loop", "cond")]
        got[paddle.__name__] = (_codes(diags), ops)
    assert got["paddle_tpu_torch"] == got["paddle_tpu"]
    assert got["paddle_tpu_torch"][1] == [
        ("while_loop", "unmodeled", 0, False), ("cond", "unmodeled", 0,
                                                False)]


def test_control_flow_closure_reads_in_the_def_use_graph(static):
    """A Variable read only inside a branch is a consumer edge of the
    cond node, and a Variable of another Program leaked into a branch is
    the verifier's replay-closure error, as in paddle_tpu."""
    for paddle in SIDES:
        paddle.enable_static()
        other = paddle.static.Program()
        with paddle.static.program_guard(other):
            foreign = paddle.static.data("f", [2], "float32")
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            x = paddle.static.data("x", [2], "float32")
            z = paddle.static.data("z", [2], "float32")
            out = paddle.static.nn.cond(x.sum() > 0, lambda: z + foreign,
                                        lambda: z)
        paddle.disable_static()
        diags = main.verify(fetch_list=[out], raise_on_error=False)
        leaks = [d for d in diags if d.pass_name == "cross-program-leak"]
        assert len(leaks) == 1 and "replay closure" in leaks[0].message
        assert len(main.nodes[-1].extra_vars) == 2


# -------------------------------------------------- kept differences --
def test_python_if_and_while_loop_grads_inside_train_step(cpu):
    """No traced regime: inside ``jit.TrainStep`` a Python ``if`` on a
    tensor runs (paddle_tpu raises) and a ``while_loop`` carries
    gradients to the parameters it reads (XLA's While has none)."""
    pt = paddle_tpu_torch

    class Net(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = pt.nn.Linear(3, 3)

        def forward(self, x):
            if x.sum() > 0:              # a Python branch on a tensor
                x = x * 2.0
            _, h = pt.while_loop(lambda i, h: i < 3,
                                 lambda i, h: (i + 1, self.lin(h)),
                                 [pt.zeros([], dtype="int64"), x])
            return h

    pt.seed(0)
    net = Net()
    before = net.lin.weight.numpy().copy()
    opt = pt.optimizer.SGD(0.1, parameters=net.parameters())
    step = pt.jit.TrainStep(net, lambda out, y: ((out - y) ** 2).mean(),
                            opt)
    x = pt.to_tensor(np.ones((2, 3), np.float32))
    loss = step(x, pt.to_tensor(np.zeros((2, 3), np.float32)))
    assert np.isfinite(float(loss))
    assert not np.allclose(net.lin.weight.numpy(), before)


@pytest.mark.cuda
def test_cuda_static_while_loop_matches_the_cpu(static):
    """The static decode and cond on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = []
    for dev in ("cpu", "gpu"):
        paddle_tpu_torch.set_device(dev)
        main, fetch = _decode_program(paddle_tpu_torch)
        got.append(paddle_tpu_torch.static.Executor().run(
            main, feed={"seed": np.array(2, np.int64),
                        "x": -np.ones((3, 4), np.float32)},
            fetch_list=fetch))
    for u, v in zip(*got):
        np.testing.assert_array_equal(v, u)
