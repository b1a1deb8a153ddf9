"""paddle_tpu_torch's dy2static and ``jit.to_static`` control flow held
to paddle_tpu's on the CPU: the 8 ``jit.to_static`` cases of
``tests/test_control_flow.py`` and 50 of the 51 cases of
``tests/test_dy2static.py``, each run by both packages on the same
inputs (f32 results within rtol/atol 1e-5, the loud refusals alike).

The port runs a ``to_static`` function eagerly, so what paddle_tpu's
cases see as "traced" the port shows where it matters, in a saved
program: a function with a tensor ``if`` (and ``cond``, ``case``,
``switch_case``), one with a tensor ``while`` (and ``while_loop``, a
``for`` with a ``break``) are saved with ``jit.save``, loaded, and fed
inputs that take the other branch, or another trip count, than the
export's example; each gives paddle_tpu's answer, and each saved graph
holds torch's ``cond`` / ``while_loop`` node.

Not twinned: ``test_print_assert_fallback_without_host_callbacks``
(it switches off JAX's host callbacks, which the port does not use: its
print and assert run eagerly).  ``test_traced_loop_break_lowers_to_
while`` counts a side-effecting probe per trace: the port's eager call
runs the body once an iteration, so its twin checks the saved graph's
one ``while_loop`` node and its trip counts instead (torch refuses a
side effect inside a traced loop body).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement

SIDES = (paddle_tpu, paddle_tpu_torch)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _t(paddle, vals, dtype="float32"):
    return paddle.to_tensor(np.array(vals, dtype))


def _v(out):
    return np.asarray(out.numpy())


def _agree(results):
    """results: [paddle_tpu's, the port's] (arrays or lists of them)."""
    j, t = results
    if isinstance(j, (list, tuple)):
        for a, b in zip(j, t):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)
    else:
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def _saved(fn, tmp_path, *specs):
    """The port's ``to_static`` function saved and loaded back."""
    from paddle_tpu_torch import jit
    path = str(tmp_path / getattr(fn, "__name__", "fn"))
    jit.save(fn, path, input_spec=[jit.InputSpec(*s) for s in specs])
    return jit.load(path)


def _hop_targets(layer):
    """torch's control-flow nodes of the saved graph, by name."""
    return [f"higher_order.{n.target.name()}"
            for n in layer.program.graph.nodes if n.op == "call_function"
            and isinstance(n.target, torch._ops.HigherOrderOperator)]


# ------------------------------------ tests/test_control_flow.py's cases --
def test_cond_traced_switches_at_runtime(cpu, tmp_path):
    res, fns = [], []
    for paddle in SIDES:
        @paddle.jit.to_static
        def fn(x):
            return paddle.cond(x.sum() > 0, lambda: x * 2, lambda: x - 1)

        res.append([_v(fn(_t(paddle, [1.0, 2.0]))),
                    _v(fn(_t(paddle, [-1.0, -2.0])))])
        fns.append(fn)
    np.testing.assert_allclose(res[0][0], [2.0, 4.0])
    np.testing.assert_allclose(res[0][1], [-2.0, -3.0])
    _agree(res)
    loaded = _saved(fns[1], tmp_path, ([None], "float32"))
    assert "higher_order.cond" in _hop_targets(loaded)
    for vals, want in zip(([1.0, 2.0], [-1.0, -2.0, -5.0], [-1.0, 5.0]),
                          ([2.0, 4.0], [-2.0, -3.0, -6.0], [-2.0, 10.0])):
        np.testing.assert_allclose(loaded(np.array(vals, "float32"))
                                   .numpy(), want)


@pytest.mark.parametrize("vals", [[1.0, 2.0], [-1.0, -2.0]])
def test_cond_traced_grad_parity(cpu, vals):
    grads = []
    for paddle in SIDES:
        def raw(x):
            return paddle.cond(x.sum() > 0, lambda: (x * x).sum(),
                               lambda: (2 * x).sum())

        fn = paddle.jit.to_static(raw)
        x1 = paddle.to_tensor(np.array(vals, np.float32),
                              stop_gradient=False)
        fn(x1).backward()
        x2 = paddle.to_tensor(np.array(vals, np.float32),
                              stop_gradient=False)
        raw(x2).backward()
        np.testing.assert_allclose(_v(x1.grad), _v(x2.grad), rtol=1e-5)
        grads.append(_v(x1.grad))
    _agree(grads)


def test_python_while_on_traced_tensor_converts(cpu, tmp_path):
    res, fns = [], []
    for paddle in SIDES:
        @paddle.jit.to_static
        def fn(x):
            out = x
            while x.sum() > 0:
                out = out * 2
                x = x - 1
            return out

        res.append(_v(fn(paddle.ones([2]))))
        fns.append(fn)
    np.testing.assert_allclose(res[0], [2.0, 2.0])
    _agree(res)
    loaded = _saved(fns[1], tmp_path, ([2], "float32"))
    assert "higher_order.while_loop" in _hop_targets(loaded)
    np.testing.assert_allclose(loaded(np.full(2, 3.0, "float32")).numpy(),
                               [24.0, 24.0])        # three trips


def test_python_if_on_traced_tensor_raises_loudly(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def fn(x):
            out = []
            while x.sum() > 0:   # body appends to a list: not convertible
                out.append(x)
                x = x - 1
            return out

        with pytest.raises(TypeError, match="paddle.while_loop"):
            fn(paddle.ones([2]))


def test_case_traced(cpu, tmp_path):
    res, fns = [], []
    for paddle in SIDES:
        @paddle.jit.to_static
        def fn(x):
            s = x.sum()
            return paddle.case(
                [(s < 0, lambda: x - 10), (s < 10, lambda: x * 2)],
                default=lambda: x + 100)

        res.append([float(fn(_t(paddle, [v]))) for v in (-5.0, 3.0, 50.0)])
        fns.append(fn)
    assert res[0] == [-15.0, 6.0, 150.0]
    _agree(res)
    loaded = _saved(fns[1], tmp_path, ([1], "float32"))
    assert [float(loaded(np.array([v], "float32"))) for v in
            (-5.0, 3.0, 50.0)] == res[0]


def test_switch_case_eager_and_traced(cpu, tmp_path):
    res, fns = [], []
    for paddle in SIDES:
        def fns_():
            return {1: lambda: paddle.full([1], 10.0),
                    3: lambda: paddle.full([1], 30.0)}

        eager = [float(paddle.switch_case(
            paddle.to_tensor(i), fns_(),
            default=lambda: paddle.full([1], -1.0))) for i in (3, 7)]

        @paddle.jit.to_static
        def fn(i):
            return paddle.switch_case(
                i, {1: lambda: paddle.full([1], 10.0),
                    3: lambda: paddle.full([1], 30.0)},
                default=lambda: paddle.full([1], -1.0))

        res.append(eager + [float(fn(paddle.to_tensor(i)))
                            for i in (1, 3, 2)])
        fns.append(fn)
    assert res[0] == [30.0, -1.0, 10.0, 30.0, -1.0]
    _agree(res)
    loaded = _saved(fns[1], tmp_path, ([], "int64"))
    assert [float(loaded(np.int64(i))) for i in (1, 3, 2)] == res[0][2:]


def test_while_loop_traced_parity(cpu, tmp_path):
    res, fns = [], []
    for paddle in SIDES:
        @paddle.jit.to_static
        def pow_n(x, n):
            def cond(i, acc):
                return i < n

            def body(i, acc):
                return i + 1, acc * x

            _, acc = paddle.while_loop(
                cond, body, [paddle.zeros([], dtype="int32"),
                             paddle.ones([], dtype="float32")])
            return acc

        x = paddle.to_tensor(np.array(3.0, np.float32))
        res.append([float(pow_n(x, paddle.to_tensor(np.int32(k))))
                    for k in (2, 4)])
        fns.append(pow_n)
    assert res[0] == [9.0, 81.0]
    _agree(res)
    loaded = _saved(fns[1], tmp_path, ([], "float32"), ([], "int32"))
    assert "higher_order.while_loop" in _hop_targets(loaded)
    assert [float(loaded(np.float32(3.0), np.int32(k))) for k in
            (2, 4, 0)] == [9.0, 81.0, 1.0]


def test_while_loop_dynamic_decode(cpu):
    eos, maxlen = 0, 8
    res = []
    for paddle in SIDES:
        @paddle.jit.to_static
        def decode(logits_seed):
            def cond(t, tok, out):
                return paddle.logical_and(t < maxlen,
                                          paddle.logical_not(tok == eos))

            def body(t, tok, out):
                nxt = paddle.mod(tok * 3 + logits_seed, paddle.full(
                    [], 5, dtype="int64"))
                out = paddle.scatter(
                    out, t.reshape([1]),
                    nxt.reshape([1, 1]).astype("float32"))
                return t + 1, nxt, out

            t0 = paddle.zeros([], dtype="int64")
            tok0 = paddle.full([], 3, dtype="int64")
            buf = paddle.full([maxlen, 1], -1.0)
            t, tok, out = paddle.while_loop(cond, body, [t0, tok0, buf])
            return t, out

        got = []
        for seed in (1, 2):
            t, out = decode(paddle.full([], seed, dtype="int64"))
            got += [int(t), _v(out)]
        res.append(got)
    assert res[0][0] == 1 and res[0][2] == 2
    assert res[1][0] == 1 and res[1][2] == 2
    np.testing.assert_allclose(res[1][1], res[0][1])
    np.testing.assert_allclose(res[1][3], res[0][3])


# ------------------------------------- tests/test_dy2static.py's cases --
def test_if_else_assignment_pattern_converts(cpu, tmp_path):
    res, fns = [], []
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            if x.sum() > 0:
                y = x * 2
            else:
                y = x - 1
            return y + 10

        res.append([_v(f(_t(paddle, [1.0, 2.0]))),
                    _v(f(_t(paddle, [-1.0, -2.0])))])
        fns.append(f)
    np.testing.assert_allclose(res[0][0], [12.0, 14.0])
    np.testing.assert_allclose(res[0][1], [8.0, 7.0])
    _agree(res)
    # saved with a zero example: both branches stay in the graph
    loaded = _saved(fns[1], tmp_path, ([None], "float32"))
    assert "higher_order.cond" in _hop_targets(loaded)
    np.testing.assert_allclose(loaded(np.array([1.0, 2.0], "float32"))
                               .numpy(), res[0][0])
    np.testing.assert_allclose(loaded(np.array([-1.0, -2.0], "float32"))
                               .numpy(), res[0][1])
    np.testing.assert_allclose(loaded(np.array([-4.0], "float32")).numpy(),
                               [5.0])


def test_early_return_pattern_converts(cpu, tmp_path):
    fns = []
    for paddle in SIDES:
        @paddle.jit.to_static
        def relu_ish(x):
            if x.sum() > 0:
                return x
            return -x

        assert float(relu_ish(_t(paddle, [3.0]))) == 3.0
        assert float(relu_ish(_t(paddle, [-3.0]))) == 3.0
        fns.append(relu_ish)
    loaded = _saved(fns[1], tmp_path, ([1], "float32"))
    assert [float(loaded(np.array([v], "float32"))) for v in (3.0, -3.0)] \
        == [3.0, 3.0]


def test_if_return_else_return_converts(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def pick(x):
            if x.mean() > 0:
                return x * 10
            else:
                return x * 100

        assert float(pick(_t(paddle, [1.0]))) == 10.0
        assert float(pick(_t(paddle, [-1.0]))) == -100.0


def test_multi_assign_both_branches(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            if x.sum() > 0:
                a = x + 1
                b = x * 2
            else:
                a = x - 1
                b = x / 2
            return a + b

        np.testing.assert_allclose(float(f(_t(paddle, [2.0]))), 7.0)
        np.testing.assert_allclose(float(f(_t(paddle, [-2.0]))), -4.0)


def test_static_if_on_python_value_untouched(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x, flag=True):
            if flag:
                return x * 2
            return x

        assert float(f(_t(paddle, [2.0]))) == 4.0


def test_single_arm_if_converts(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            if x.sum() > 0:
                x = x * 2
            return x

        assert float(_v(f(_t(paddle, [3.0])))[0]) == 6.0
        assert float(_v(f(_t(paddle, [-3.0])))[0]) == -3.0


def test_unconvertible_pattern_still_fails_loudly(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            if x.sum() > 0:
                y = x * 2      # branches assign different names
            else:
                z = x
            return x

        with pytest.raises(TypeError, match="paddle.cond"):
            f(paddle.ones([2]))


def test_converted_if_differentiable(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            if x.sum() > 0:
                y = (x * x).sum()
            else:
                y = x.sum()
            return y

        x = paddle.to_tensor(np.array([1.0, 2.0], np.float32),
                             stop_gradient=False)
        f(x).backward()
        np.testing.assert_allclose(_v(x.grad), [2.0, 4.0])


def test_layer_forward_with_tensor_if(cpu):
    x = np.random.RandomState(0).standard_normal((2, 4)).astype("float32")
    w = np.random.RandomState(1).standard_normal((4, 4)).astype("float32")
    res = []
    for paddle in SIDES:
        class Net(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = paddle.nn.Linear(4, 4)

            @paddle.jit.to_static
            def forward(self, x):
                h = self.fc(x)
                if h.sum() > 1e9:   # never true, but must hold both
                    out = h * 0
                else:
                    out = h + 1
                return out

        net = Net()
        net.fc.weight.set_value(w)
        net.fc.bias.set_value(np.zeros(4, "float32"))
        xt = paddle.to_tensor(x)
        got = _v(net(xt))
        np.testing.assert_allclose(got, _v(net.fc(xt) + 1), rtol=1e-6)
        res.append(got)
    _agree(res)


def test_branch_self_assignment_converts(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def g(x, flag=True):
            if flag:
                x = x + 1
            else:
                x = x - 1
            return x

        assert float(g(_t(paddle, [1.0]))) == 2.0

        @paddle.jit.to_static
        def h(x):
            if x.sum() > 0:
                x = x * 2
            else:
                x = x - 1
            return x

        np.testing.assert_allclose(_v(h(paddle.ones([2]))), [2.0, 2.0])
        np.testing.assert_allclose(_v(h(_t(paddle, [-1.0, -1.0]))),
                                   [-2.0, -2.0])


def test_chained_assign_after_define_converts(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            if x.sum() > 0:
                a = x * 2
                b = a + 1
            else:
                a = x - 1
                b = a * 3
            return b

        np.testing.assert_allclose(float(f(_t(paddle, [1.0]))), 3.0)
        np.testing.assert_allclose(float(f(_t(paddle, [-1.0]))), -6.0)


def test_while_loop_converts_under_to_static(cpu, tmp_path):
    res, fns = [], []
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            s = x * 0
            while s.sum() < 10:
                s = s + x
            return s

        res.append([_v(f(_t(paddle, [1.0, 1.0]))),
                    _v(f(_t(paddle, [2.0, 2.0])))])
        fns.append(f)
    np.testing.assert_allclose(res[0][0], [5.0, 5.0])
    np.testing.assert_allclose(res[0][1], [6.0, 6.0])
    _agree(res)
    # the trip count is read at run time: 5, 3 and 2 trips
    loaded = _saved(fns[1], tmp_path, ([2], "float32"))
    assert "higher_order.while_loop" in _hop_targets(loaded)
    for v, want in ((1.0, 5.0), (2.0, 6.0), (3.0, 6.0), (4.5, 9.0)):
        np.testing.assert_allclose(loaded(np.full(2, v, "float32")).numpy(),
                                   [want, want])


def _convert(paddle):
    import importlib
    return importlib.import_module(
        paddle.__name__ + ".jit.dy2static").convert_control_flow


def test_while_eager_semantics_unchanged(cpu):
    for paddle in SIDES:
        def f(n):
            s = 0
            while s < n:
                s = s + 3
            return s

        g = _convert(paddle)(f)
        assert g is not f
        assert g(10) == f(10) == 12


def test_for_range_converts(cpu):
    res = []
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x, n):
            acc = x * 0
            for i in range(n):
                acc = acc + x * (i + 1)
            return acc

        res.append(_v(f(_t(paddle, [1.0, 2.0]),
                        paddle.to_tensor(np.int32(4)))))
    np.testing.assert_allclose(res[0], [10.0, 20.0])
    _agree(res)


def test_loop_with_leading_break(cpu):
    res = []
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            s = x * 0
            k = x.sum() * 0
            while k < 100:
                if s.sum() > 6:
                    break
                s = s + x
                k = k + 1
            return s

        res.append(_v(f(_t(paddle, [1.0, 1.0]))))
    np.testing.assert_allclose(res[0], [4.0, 4.0])
    _agree(res)


def test_loop_with_tail_break(cpu):
    for paddle in SIDES:
        def f(lim):
            s = 0
            while True:
                s = s + 2
                if s >= lim:
                    break
            return s

        g = _convert(paddle)(f)
        assert g is not f
        assert g(7) == f(7) == 8


def test_loop_with_continue(cpu):
    for paddle in SIDES:
        def f(n):
            s = 0
            i = 0
            while i < n:
                i = i + 1
                if i % 2 == 0:
                    continue
                s = s + i
            return s

        assert _convert(paddle)(f)(6) == f(6) == 9


def test_nested_if_inside_loop_converts(cpu):
    res = []
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            s = x * 0
            for i in range(4):
                if s.sum() > 2:
                    s = s + x * 2
                else:
                    s = s + x
            return s

        res.append(_v(f(_t(paddle, [1.0, 1.0]))))
    np.testing.assert_allclose(res[0], [6.0, 6.0])
    _agree(res)


def test_unconvertible_loop_left_untouched(cpu):
    for paddle in SIDES:
        def f(xs):
            out = []
            for x in xs:
                out.append(x * 2)
            return out

        assert _convert(paddle)(f)([1, 2]) == [2, 4]


def test_break_predicate_reads_body_assigned_name(cpu):
    for paddle in SIDES:
        def f(x):
            s = 0
            k = 0
            t = 0
            while k < 100:
                if t > 6:
                    break
                t = s + 1
                s = s + x
                k = k + 1
            return s

        assert _convert(paddle)(f)(1) == f(1) == 7


def test_unbound_prebind_name_not_converted(cpu):
    for paddle in SIDES:
        def f(flag):
            if flag:
                y = y_missing_on_purpose + 1  # noqa: F821
            else:
                y = 0
            return y

        assert _convert(paddle)(f)(False) == 0

        def h(flag):
            if flag:
                z = z + 1  # noqa: F821 — z unbound: must not prebind
            else:
                z = 0
            return z

        assert _convert(paddle)(h)(False) == 0


def test_tensor_if_inside_tensor_while_converts(cpu, tmp_path):
    res, fns = [], []
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            s = x * 0
            while s.sum() < 6:
                if s.sum() > 2:
                    s = s + x * 2
                else:
                    s = s + x
            return s

        res.append(_v(f(_t(paddle, [1.0, 1.0]))))
        fns.append(f)
    np.testing.assert_allclose(res[0], [4.0, 4.0])
    _agree(res)
    loaded = _saved(fns[1], tmp_path, ([2], "float32"))
    np.testing.assert_allclose(loaded(np.ones(2, "float32")).numpy(),
                               [4.0, 4.0])
    np.testing.assert_allclose(loaded(np.full(2, 2.0, "float32")).numpy(),
                               [6.0, 6.0])


def _eager_vs_static(paddle, fn, *inputs):
    eager = fn(*inputs)
    static = paddle.jit.to_static(fn)(*inputs)
    np.testing.assert_allclose(_v(static), _v(eager), rtol=1e-6)
    return _v(static)


def test_mid_body_break(cpu):
    res = []
    for paddle in SIDES:
        def f(x):
            s = paddle.zeros([2])
            i = 0
            while i < 10:
                s = s + x
                if s.sum() > 6:
                    break
                s = s * 1.5
                i = i + 1
            return s

        res.append(_eager_vs_static(paddle, f, _t(paddle, [1.0, 1.0])))
    _agree(res)


def test_mid_body_continue_in_for(cpu):
    res = []
    for paddle in SIDES:
        def f(x):
            s = x * 0
            for i in range(6):
                s = s + x
                if s.sum() > 4:
                    continue
                s = s + 100 * x
            return s

        res.append(_eager_vs_static(paddle, f, _t(paddle, [1.0])))
    _agree(res)


@pytest.mark.parametrize("v", [0.5, 1.0, 3.0])
def test_multiple_exits_mixed(cpu, v):
    res = []
    for paddle in SIDES:
        def f(x):
            s = x * 0
            for i in range(8):
                if s.sum() > 20:
                    break
                s = s + x
                if s.sum() < 2:
                    continue
                s = s * 2
            return s

        res.append(_eager_vs_static(paddle, f, _t(paddle, [v])))
    _agree(res)


def test_break_with_payload_assignment(cpu):
    res = []
    for paddle in SIDES:
        def f(x):
            s = x * 0
            flag = paddle.zeros([1])
            for i in range(5):
                s = s + x
                if s.sum() > 2:
                    flag = flag + 1
                    break
            return s + flag * 10

        res.append(_eager_vs_static(paddle, f, _t(paddle, [1.0])))
    _agree(res)


def test_early_return_inside_loop(cpu):
    res = []
    for paddle in SIDES:
        def f(x):
            s = x * 0
            for i in range(10):
                s = s + x
                if s.sum() > 3:
                    return s * 100
            return s

        res.append([_eager_vs_static(paddle, f, _t(paddle, [v]))
                    for v in (1.0, 0.1)])
    _agree(res)


def test_early_return_inside_while(cpu):
    res = []
    for paddle in SIDES:
        def f(x):
            s = x * 0
            i = 0
            while i < 20:
                s = s + x
                if s.sum() > 5:
                    return -s
                i = i + 1
            return s

        res.append([_eager_vs_static(paddle, f, _t(paddle, [v]))
                    for v in (2.0, 0.1)])
    _agree(res)


def _helper_double_or_neg(v):
    # module-level helper with a tensor if: converted when called from
    # a to_static function
    if v.sum() > 0:
        return v * 2
    return -v


def test_nested_call_converts(cpu):
    res = []
    for paddle in SIDES:
        def f(x):
            y = _helper_double_or_neg(x)
            return y + 1

        res.append([_eager_vs_static(paddle, f, _t(paddle, [v]))
                    for v in (2.0, -2.0)])
    _agree(res)


def test_nested_call_inside_loop_converts(cpu):
    res = []
    for paddle in SIDES:
        def f(x):
            s = x * 0
            for i in range(4):
                s = _helper_double_or_neg(s + x)
            return s

        res.append([_eager_vs_static(paddle, f, _t(paddle, [v]))
                    for v in (1.0, -1.0)])
    _agree(res)


def test_nested_call_shadowed_name_stays_loud(cpu):
    for paddle in SIDES:
        def f(x):
            _local = _helper_double_or_neg
            return _local(x)

        x = _t(paddle, [1.5])
        assert float(_v(f(x))[0]) == 3.0
        with pytest.raises(TypeError, match="paddle.cond"):
            paddle.jit.to_static(f)(x)


def test_jst_call_passthrough(cpu):
    import importlib
    for paddle in SIDES:
        d2s = importlib.import_module(paddle.__name__ + ".jit.dy2static")
        assert d2s._jst_call(len) is len
        assert d2s._jst_call(range) is range
        assert d2s._jst_call(np.sum) is np.sum
        obj = object()
        assert d2s._jst_call(obj) is obj
        c1 = d2s._jst_call(_helper_double_or_neg)
        c2 = d2s._jst_call(_helper_double_or_neg)
        assert c1 is c2 and c1 is not _helper_double_or_neg


def test_traced_loop_break_lowers_to_while(cpu, tmp_path):
    calls = [0]

    def probe(v):
        calls[0] += 1
        return v

    def f(x):
        s = x * 0
        for i in range(100):
            s = s + probe(x)
            if s.sum() > 10:
                break
        return s

    # paddle_tpu traces the body at most twice
    out = paddle_tpu.jit.to_static(f)(_t(paddle_tpu, [3.0]))
    assert float(_v(out)[0]) == 12.0
    assert calls[0] <= 2, calls[0]
    # the port runs it eagerly: one body per iteration, same answer
    calls[0] = 0
    out = paddle_tpu_torch.jit.to_static(f)(_t(paddle_tpu_torch, [3.0]))
    assert float(_v(out)[0]) == 12.0 and calls[0] == 4

    # saved: one while_loop node, not an unrolled or fixed-count loop
    def g(x):
        s = x * 0
        for i in range(100):
            s = s + x
            if s.sum() > 10:
                break
        return s

    loaded = _saved(paddle_tpu_torch.jit.to_static(g), tmp_path,
                    ([1], "float32"))
    assert _hop_targets(loaded).count("higher_order.while_loop") == 1
    for v, want in ((3.0, 12.0), (0.5, 10.5), (20.0, 20.0)):
        assert float(loaded(np.array([v], "float32"))) == want


@pytest.mark.parametrize("case", ["body_temp", "loop_index", "payload",
                                  "nontrailing"])
def test_unconvertible_loop_returns_bail_loudly(cpu, case):
    """The four ``*_bails_loudly`` cases of ``tests/test_dy2static.py``:
    eagerly each runs; under ``to_static`` each raises naming
    paddle.cond."""
    for paddle in SIDES:
        if case == "body_temp":
            def f(x):
                s = x * 0
                for i in range(5):
                    t = x * 2.0
                    if t.sum() > 3:
                        return t
                    s = s + t
                return s
            x, want = _t(paddle, [2.0]), 4.0
        elif case == "loop_index":
            def f(x):
                s = x * 0
                for i in range(5):
                    s = s + x
                    if s.sum() > 2:
                        return s * i
                return s
            x, want = _t(paddle, [1.0]), 6.0
        elif case == "payload":
            def f(x):
                s = x * 0
                for i in range(5):
                    s = s + x
                    if s.sum() > 2:
                        msg = s * 0
                        break
                return s + msg  # noqa: F821
            x, want = _t(paddle, [1.0]), 3.0
        else:
            def f(x):
                s = x * 0
                for i in range(10):
                    s = s + x
                    if s.sum() > 3:
                        return s * 100
                y = s * 2
                return y
            x, want = _t(paddle, [1.0]), 400.0
        assert float(_v(f(x))[0]) == want
        with pytest.raises(TypeError, match="paddle.cond"):
            paddle.jit.to_static(f)(x)


def test_print_inside_traced_fn(cpu, capfd):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            y = x * 2
            print("value:", y)
            return y + 1

        assert float(_v(f(_t(paddle, [3.0])))[0]) == 7.0
        captured = capfd.readouterr()
        text = captured.out + captured.err
        assert "6." in text and "Tracer" not in text


def test_print_in_converted_loop(cpu, capfd):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            s = x * 0
            for i in range(3):
                s = s + x
                print(s)
            return s

        assert float(_v(f(_t(paddle, [1.0])))[0]) == 3.0
        cap = capfd.readouterr()
        assert (cap.out + cap.err).count("[") >= 3


def test_cast_on_traced_tensor(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            i = int(x)
            fl = float(i)
            return fl * 2

        assert float(_v(f(_t(paddle, [3.7])))[0]) == 6.0


def test_cast_concrete_passthrough(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x, k):
            n = int(k)
            return x * n

        assert float(_v(f(_t(paddle, [2.0]), 3.9))[0]) == 6.0


def test_assert_traced_checks_at_runtime(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            assert x.sum() > 0, "must be positive"
            return x * 2

        assert float(_v(f(_t(paddle, [1.0])))[0]) == 2.0
        with pytest.raises(Exception, match="must be positive"):
            _v(f(_t(paddle, [-1.0])))


def test_assert_concrete_keeps_python_semantics(cpu):
    for paddle in SIDES:
        def g(flag):
            assert flag, "nope"
            return 1

        conv = paddle.jit.to_static(g)
        assert conv(True) == 1
        with pytest.raises(AssertionError, match="nope"):
            conv(False)


def test_shadowed_builtin_names_untouched(cpu):
    for paddle in SIDES:
        def h(x, int):
            if x.sum() > 0:
                y = x
            else:
                y = -x
            return y * int(x)

        out = paddle.jit.to_static(h)(_t(paddle, [2.0]), lambda v: 10.0)
        assert float(_v(out)[0]) == 20.0


def test_bt_only_conversion_keeps_live_closures(cpu):
    for paddle in SIDES:
        def outer():
            def set_factor(v):
                nonlocal_set(v)

            def nonlocal_set(v):
                nonlocal real_factor
                real_factor = v

            real_factor = 2.0

            def inner(x):
                print("factor is", real_factor)
                return x * real_factor

            return inner, set_factor

        inner, set_factor = outer()
        conv = _convert(paddle)(inner)
        assert conv is inner
        assert conv(1.0) == 2.0
        set_factor(5.0)
        assert conv(1.0) == 5.0


def test_assert_msg_lazy(cpu):
    for paddle in SIDES:
        calls = [0]

        def expensive():
            calls[0] += 1
            return "boom"

        @paddle.jit.to_static
        def f(x):
            assert x.sum() > 0, expensive()
            return x * 2

        f(_t(paddle, [1.0]))
        assert calls[0] == 0


def test_print_sep_honored_and_file_falls_back(cpu, capfd):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            print("v", x, sep="|")
            return x

        f(_t(paddle, [1.0]))
        cap = capfd.readouterr()
        assert "v|" in (cap.out + cap.err)


def test_logical_and_or_not_on_tensors(cpu):
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            if (x.sum() > 0) and (x.max() < 10):
                y = x * 2
            else:
                y = x * 0
            if not (x.sum() > 100) or (x.min() < -50):
                y = y + 1
            return y

        assert float(_v(f(_t(paddle, [2.0])))[0]) == 5.0
        assert float(_v(f(_t(paddle, [20.0])))[0]) == 1.0


def test_logical_short_circuit_preserved_eager(cpu):
    for paddle in SIDES:
        calls = []

        def right():
            calls.append(1)
            return "rhs"

        def f(flag):
            a = flag and right()
            b = flag or right()
            return a, b

        conv = _convert(paddle)(f)
        a, b = conv(False)
        assert a is False and len(calls) == 1
        assert b == "rhs"
        calls.clear()
        a, b = conv(True)
        assert a == "rhs" and b is True and len(calls) == 1


def test_logical_in_while_test(cpu):
    res = []
    for paddle in SIDES:
        @paddle.jit.to_static
        def f(x):
            s = x * 0
            i = 0
            while (i < 10) and (s.sum() < 5):
                s = s + x
                i = i + 1
            return s

        res.append(float(_v(f(_t(paddle, [2.0])))[0]))
    assert res == [6.0, 6.0]


# ------------------------------ jit.lint (tests/test_static_analysis.py) --
def _fx_unconvertible_if(x):
    if x.sum() > 0:
        y = x * 2      # branches assign different name sets: no convert
        z = y + 1
    else:
        z = x - 1
    return z


def _fx_side_effect_loop(x):
    acc = x
    out = []
    while acc.sum() < 10:
        out.append(acc)
        acc = acc + 1
    return acc


def _fx_shadowed_builtin(x, print=None):
    print(x)
    return x


def _fx_clean(x):
    if x.sum() > 0:
        y = x * 2
    else:
        y = x - 1
    return y


def _fx_concrete_control_flow(x, flag=True):
    if x is None:
        return x
    if isinstance(x, int):
        return x
    for i in range(3):
        x = x + i
    return x


def _fx_shape_metadata_control_flow(x):
    out = []
    if x.shape[0] > 1:
        out.append(1)
    for i in range(x.ndim):
        out.append(i)
    return x


def _fx_tensor_for_with_print(x):
    for t in x:
        print(t)
        y = t + 1
    return x


def _fx_host_sync(x):
    v = x.numpy()
    n = int(x.sum())
    return v, n


def _diags(paddle, fn):
    return [(d.code, d.severity, d.file, d.line, d.message)
            for d in paddle.jit.lint(fn)]


@pytest.mark.parametrize("fixture,codes", [
    (_fx_unconvertible_if, ["D2S101"]),
    (_fx_side_effect_loop, ["D2S101", "D2S102"]),
    (_fx_shadowed_builtin, ["D2S103"]),
    (_fx_clean, []),
    (_fx_concrete_control_flow, []),
    (_fx_shape_metadata_control_flow, []),
    (_fx_tensor_for_with_print, ["D2S101"]),
    (_fx_host_sync, ["D2S104", "D2S104"]),
])
def test_lint_matches_paddle_tpu(fixture, codes):
    """The cases of ``tests/test_static_analysis.py``'s lint section:
    the same diagnostics, anchors and messages from both packages."""
    got = [_diags(paddle, fixture) for paddle in SIDES]
    assert got[1] == got[0]
    assert sorted(d[0] for d in got[1]) == sorted(codes)
    for code, _, file, line, _ in got[1]:
        assert file.endswith("test_torch_dy2static.py")
        assert line > 0


def test_lint_accepts_to_static_wrapper_and_never_runs_the_function(cpu):
    hits = []

    def bomb(x):
        hits.append(1)
        if x.sum() > 0:
            x.numpy()
            y = 1
        return x

    for paddle in SIDES:
        wrapped = paddle.jit.to_static(_fx_unconvertible_if)
        assert [d.code for d in paddle.jit.lint(wrapped)] == ["D2S101"]
        assert paddle.jit.lint(bomb) != []
    assert hits == []
