"""Eager autograd of the port against paddle_tpu's tape: the cases of
``tests/test_autograd.py`` run as the same user code on both packages
(``pkg`` is ``paddle_tpu`` or ``paddle_tpu_torch`` on the CPU), with
the same expected gradients (rtol 1e-6) and the same exception classes
on the error paths (``type(err) is RuntimeError`` in both)."""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement

PKGS = {"jax": paddle_tpu, "torch": paddle_tpu_torch}


@pytest.fixture(params=sorted(PKGS))
def paddle(request):
    prev = placement.default()
    if request.param == "torch":
        paddle_tpu_torch.set_device("cpu")
    yield PKGS[request.param]
    placement.set_default(prev)


def close(a, b, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol)


def raises_exactly(cls):
    """``pytest.raises`` that also holds the class itself (not a
    subclass), so both packages raise the same one."""
    class _Ctx:
        def __enter__(self):
            self.cm = pytest.raises(cls)
            self.info = self.cm.__enter__()
            return self.info

        def __exit__(self, *exc):
            r = self.cm.__exit__(*exc)
            assert self.info.type is cls, self.info.type
            return r
    return _Ctx()


def test_simple_backward(paddle):
    x = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    (x * x).sum().backward()
    close(x.grad.numpy(), [2, 4, 6])
    assert isinstance(x.grad, paddle.Tensor)


def test_chain_rule_two_ops(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = x * x
    (y * x).backward()
    close(x.grad.numpy(), [12.0])


def test_grad_accumulation_across_backwards(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    close(x.grad.numpy(), [5.0])
    x.clear_grad()
    assert x.grad is None


def test_stop_gradient_blocks_flow(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = paddle.to_tensor([2.0], stop_gradient=True)
    (x * y).sum().backward()
    close(x.grad.numpy(), [2.0])
    assert y.grad is None


def test_detach(paddle):
    x = paddle.to_tensor([3.0], stop_gradient=False)
    d = (x * x).detach()
    (d * x).sum().backward()
    close(x.grad.numpy(), [9.0])


def test_no_grad_context_and_decorator(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        y = x * x
    assert y.stop_gradient

    @paddle.no_grad()
    def f(t):
        return t * 2
    assert f(x).stop_gradient
    with paddle.no_grad():
        with paddle.enable_grad():
            assert not (x * 2).stop_gradient


def test_matmul_grad(paddle):
    rs = np.random.RandomState(0)
    av = rs.rand(3, 4).astype(np.float32)
    bv = rs.rand(4, 5).astype(np.float32)
    a = paddle.to_tensor(av, stop_gradient=False)
    b = paddle.to_tensor(bv, stop_gradient=False)
    paddle.matmul(a, b).sum().backward()
    close(a.grad.numpy(), np.ones((3, 5)) @ bv.T, rtol=1e-5)
    close(b.grad.numpy(), av.T @ np.ones((3, 5)), rtol=1e-5)


def test_broadcast_grad(paddle):
    a = paddle.to_tensor(np.ones((3, 4), np.float32), stop_gradient=False)
    b = paddle.to_tensor(np.ones((4,), np.float32), stop_gradient=False)
    (a + b).sum().backward()
    close(b.grad.numpy(), [3, 3, 3, 3])


def test_non_scalar_backward_needs_grad(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    with raises_exactly(RuntimeError):
        y.backward()
    y = x * 2
    y.backward(paddle.to_tensor([1.0, 0.5]))
    close(x.grad.numpy(), [2.0, 1.0])


def test_paddle_grad_api(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    (gx,) = paddle.grad(x * x * x, [x])
    close(gx.numpy(), [12.0])
    assert x.grad is None


def test_paddle_grad_leaves_an_existing_grad_untouched(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    (x * 5).backward()
    (gx,) = paddle.grad(x * x, [x])
    close(gx.numpy(), [4.0])
    close(x.grad.numpy(), [5.0])


def test_grad_allow_unused(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    z = paddle.to_tensor([1.0], stop_gradient=False)
    y = x * 2
    with raises_exactly(RuntimeError):
        paddle.grad(y, [x, z], retain_graph=True)
    gx, gz = paddle.grad(y, [x, z], allow_unused=True)
    close(gx.numpy(), [2.0])
    assert gz is None


def test_register_hook(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    seen = []
    x.register_hook(lambda g: seen.append(g.numpy()))
    (x * 5).backward()
    assert len(seen) == 1
    close(seen[0], [5.0])


def test_hook_modifies_grad(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    x.register_hook(lambda g: g * 2)
    (x * 5).backward()
    close(x.grad.numpy(), [10.0])


def _numeric_grad(f, x, eps=1e-3):
    g = np.zeros_like(x)
    flat, gf = x.reshape(-1), g.reshape(-1)
    for i in range(flat.size):
        orig = flat[i]
        flat[i] = orig + eps
        f1 = f(x)
        flat[i] = orig - eps
        f0 = f(x)
        flat[i] = orig
        gf[i] = (f1 - f0) / (2 * eps)
    return g


@pytest.mark.parametrize("op,np_op", [
    ("exp", np.exp), ("tanh", np.tanh), ("sqrt", np.sqrt), ("log", np.log),
    ("sigmoid", lambda v: 1 / (1 + np.exp(-v)))])
def test_numeric_gradient_match(paddle, op, np_op):
    xv = np.random.RandomState(1).rand(3, 4) * 0.8 + 0.1
    x = paddle.to_tensor(xv.astype(np.float32), stop_gradient=False)
    getattr(paddle, op)(x).sum().backward()
    ng = _numeric_grad(lambda a: np_op(a).sum(), xv.copy())
    np.testing.assert_allclose(x.grad.numpy(), ng, rtol=1e-2, atol=1e-3)


def test_multi_output_op_grad(paddle):
    x = paddle.to_tensor(np.arange(6, dtype=np.float32), stop_gradient=False)
    parts = paddle.split(x, 3)
    (parts[0] * 1 + parts[1] * 2 + parts[2] * 3).sum().backward()
    close(x.grad.numpy(), [1, 1, 2, 2, 3, 3])


def test_setitem_grad_flow(paddle):
    x = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    y = x * 2
    y[0] = 0.0
    y.sum().backward()
    close(x.grad.numpy(), [0.0, 2.0, 2.0])


def test_second_use_of_intermediate(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = x * 3
    (y + y).backward()
    close(x.grad.numpy(), [6.0])


def test_two_independent_graphs(paddle):
    a = paddle.to_tensor([1.0], stop_gradient=False)
    l1 = (a * 2).sum()
    l2 = (a * 3).sum()
    l1.backward()
    l2.backward()
    close(a.grad.numpy(), [5.0])


def test_second_backward_raises(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    close(x.grad.numpy(), [8.0])
    with raises_exactly(RuntimeError):
        y.backward()


def test_grad_wrt_intermediate(paddle):
    x = paddle.to_tensor([3.0], stop_gradient=False)
    y = x * 2
    (gy,) = paddle.grad((y * y).sum(), [y])
    close(gy.numpy(), [12.0])


def test_is_grad_enabled_follows_no_grad(paddle):
    assert paddle.is_grad_enabled()
    with paddle.no_grad():
        assert not paddle.is_grad_enabled()
    assert paddle.is_grad_enabled()
