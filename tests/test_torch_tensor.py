"""The paddle Tensor of the port against paddle_tpu's: the cases of
``tests/test_tensor.py`` run as the same user code on both packages
(``pkg`` is ``paddle_tpu`` or ``paddle_tpu_torch`` on the CPU), with
the same expected values (f32 math at rtol 1e-6), plus the differences
the port keeps on purpose, each shown here."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement

PKGS = {"jax": paddle_tpu, "torch": paddle_tpu_torch}


@pytest.fixture(params=sorted(PKGS))
def paddle(request):
    """The package under test; the port places tensors on the CPU."""
    prev = placement.default()
    if request.param == "torch":
        paddle_tpu_torch.set_device("cpu")
    yield PKGS[request.param]
    placement.set_default(prev)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-6)


def test_to_tensor_and_numpy(paddle):
    x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert x.shape == [2, 2]
    assert x.dtype == paddle.float32
    close(x.numpy(), [[1, 2], [3, 4]])
    assert x.stop_gradient is True
    assert isinstance(x, paddle.Tensor)


def test_creation_ops(paddle):
    assert paddle.zeros([2, 3]).numpy().sum() == 0
    assert paddle.ones([2, 3]).numpy().sum() == 6
    close(paddle.full([2], 7.0).numpy(), [7, 7])
    close(paddle.arange(5).numpy(), np.arange(5))
    close(paddle.eye(3).numpy(), np.eye(3, dtype=np.float32))
    close(paddle.linspace(0, 1, 5).numpy(), np.linspace(0, 1, 5))
    close(paddle.zeros_like(paddle.ones([2])).numpy(), [0, 0])
    close(paddle.full_like(paddle.ones([2]), 3.0).numpy(), [3, 3])
    a, b = paddle.meshgrid(paddle.arange(2), paddle.arange(3))
    assert a.shape == [2, 3] and b.shape == [2, 3]
    close(paddle.assign(np.ones(2, np.float32)).numpy(), [1, 1])


def test_arithmetic_operators(paddle):
    a = paddle.to_tensor([1.0, 2.0, 3.0])
    b = paddle.to_tensor([4.0, 5.0, 6.0])
    close((a + b).numpy(), [5, 7, 9])
    close((a - b).numpy(), [-3, -3, -3])
    close((a * b).numpy(), [4, 10, 18])
    close((b / a).numpy(), [4, 2.5, 2])
    close((a ** 2).numpy(), [1, 4, 9])
    close((2.0 - a).numpy(), [1, 0, -1])
    close((-a).numpy(), [-1, -2, -3])
    close((10.0 / a).numpy(), [10, 5, 10 / 3])
    assert isinstance(a + b, paddle.Tensor)
    assert isinstance(2.0 - a, paddle.Tensor)


def test_matmul(paddle):
    a = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    b = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    close((a @ b).numpy(), a.numpy() @ b.numpy())
    d = paddle.matmul(a, b.t(), transpose_y=True)
    close(d.numpy(), a.numpy() @ b.numpy())
    e = paddle.matmul(a, a, transpose_y=True)
    close(e.numpy(), a.numpy() @ a.numpy().T)


def test_reductions(paddle):
    x = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    assert float(x.sum()) == 66
    assert float(x.mean()) == 5.5
    close(x.sum(axis=0).numpy(), [12, 15, 18, 21])
    close(x.max(axis=1).numpy(), [3, 7, 11])
    assert x.sum(axis=1, keepdim=True).shape == [3, 1]
    assert int(x.argmax()) == 11
    close(x.argmax(axis=0).numpy(), [2, 2, 2, 2])


def test_manipulation(paddle):
    x = paddle.arange(24, dtype="float32")
    y = x.reshape([2, 3, 4])
    assert y.shape == [2, 3, 4]
    assert y.transpose([2, 0, 1]).shape == [4, 2, 3]
    assert y.flatten().shape == [24]
    assert y.flatten(1, 2).shape == [2, 12]
    assert y.unsqueeze(0).shape == [1, 2, 3, 4]
    assert y.unsqueeze([0, 2]).shape == [1, 2, 1, 3, 4]
    assert paddle.concat([y, y], axis=1).shape == [2, 6, 4]
    assert paddle.stack([x, x]).shape == [2, 24]
    parts = paddle.split(paddle.ones([6, 2]), [2, 2, -1], axis=0)
    assert [p.shape for p in parts] == [[2, 2], [2, 2], [2, 2]]


def test_indexing(paddle):
    x = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    close(x[0].numpy(), [0, 1, 2, 3])
    close(x[1, 2].numpy(), 6)
    close(x[:, 1].numpy(), [1, 5, 9])
    close(x[0:2, 1:3].numpy(), [[1, 2], [5, 6]])
    idx = paddle.to_tensor(np.array([0, 2]))
    close(x[idx].numpy(), x.numpy()[[0, 2]])
    x[0, 0] = 100.0
    assert float(x[0, 0]) == 100.0


def test_gather_scatter(paddle):
    x = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(4, 3))
    idx = paddle.to_tensor(np.array([0, 2]))
    close(paddle.gather(x, idx).numpy(), x.numpy()[[0, 2]])
    s = paddle.scatter(x, idx, paddle.ones([2, 3]))
    expect = x.numpy().copy()
    expect[[0, 2]] = 1
    close(s.numpy(), expect)


def test_where_topk_sort(paddle):
    x = paddle.to_tensor([3.0, 1.0, 2.0])
    v, i = paddle.topk(x, 2)
    close(v.numpy(), [3, 2])
    close(i.numpy(), [0, 2])
    close(paddle.sort(x, descending=True).numpy(), [3, 2, 1])
    w = paddle.where(x > 1.5, x, paddle.zeros_like(x))
    close(w.numpy(), [3, 0, 2])


def test_cast_and_dtype(paddle):
    x = paddle.ones([2], dtype="float32")
    assert x.astype("int32").dtype == paddle.int32
    assert x.astype(paddle.bfloat16).dtype == paddle.bfloat16


def test_comparison_and_logic(paddle):
    a = paddle.to_tensor([1.0, 2.0, 3.0])
    b = paddle.to_tensor([3.0, 2.0, 1.0])
    np.testing.assert_array_equal((a < b).numpy(), [True, False, False])
    np.testing.assert_array_equal((a == b).numpy(), [False, True, False])
    assert bool(paddle.allclose(a, a))
    assert not bool(paddle.allclose(a, b))


def test_inplace_style(paddle):
    x = paddle.ones([2, 2])
    x.zero_()
    assert x.numpy().sum() == 0
    x.fill_(3.0)
    assert x.numpy().sum() == 12
    x.set_value(np.eye(2, dtype=np.float32))
    close(x.numpy(), np.eye(2))
    with pytest.raises(ValueError):
        x.set_value(np.ones(3, np.float32))


def test_random_reproducible(paddle):
    paddle.seed(7)
    a = paddle.randn([4, 4])
    paddle.seed(7)
    b = paddle.randn([4, 4])
    close(a.numpy(), b.numpy())
    c = paddle.rand([1000])
    assert 0.0 <= float(c.min()) and float(c.max()) <= 1.0
    r = paddle.randint(0, 10, [100])
    assert r.numpy().min() >= 0 and r.numpy().max() < 10


def test_save_load(paddle, tmp_path):
    path = str(tmp_path / "ckpt.pdparams")
    obj = {"w": paddle.ones([2, 3]), "step": 7, "nested": [paddle.zeros([1])]}
    paddle.save(obj, path)
    loaded = paddle.load(path)
    close(loaded["w"].numpy(), np.ones((2, 3)))
    assert loaded["step"] == 7
    close(loaded["nested"][0].numpy(), [0])


def test_pad_short_form_pads_last_dim_first(paddle):
    x = paddle.ones([1, 1, 2, 2])
    assert paddle.ops.pad(x, [1, 0, 0, 0]).shape == [1, 1, 2, 3]
    assert paddle.ops.pad(x, [0, 0, 1, 1]).shape == [1, 1, 4, 2]


def test_mode(paddle):
    v, _ = paddle.ops.mode(paddle.to_tensor(
        [3.0, 3.0, 3.0, 3.0, 7.0, 7.0, 1.0, 2.0]))
    assert float(v) == 3.0


def test_multinomial_batched(paddle):
    p = paddle.ones([4, 3])
    assert paddle.multinomial(p, 2, replacement=True).shape == [4, 2]
    s2 = paddle.multinomial(p, 2, replacement=False)
    assert s2.shape == [4, 2]
    assert all(len(set(r)) == 2 for r in s2.numpy())


# -- differences kept on purpose (the port only) ------------------------------

@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def test_shape_is_a_list_equal_to_the_tuple_and_size_is_torchs(cpu):
    x = cpu.ones([2, 3])
    assert isinstance(x.shape, list) and x.shape == [2, 3]
    assert x.shape == (2, 3) and x.shape == torch.Size([2, 3])
    assert hash(x.shape) == hash((2, 3))
    assert x.shape[:1] + (4,) == [2, 4] and (1,) + x.shape == [1, 2, 3]
    # ``size`` stays torch's method (torch calls it internally)
    assert x.size() == torch.Size([2, 3]) and cpu.numel(x).item() == 6


def test_integers_stay_int64(cpu):
    """paddle_tpu without x64 makes int32; the port keeps int64."""
    assert cpu.to_tensor([1, 2]).dtype == cpu.int64
    assert paddle_tpu.to_tensor([1, 2]).dtype == paddle_tpu.int32
    assert cpu.arange(3).dtype == cpu.int64
    assert cpu.argmax(cpu.ones([3])).dtype == cpu.int64


def test_random_streams_differ_from_the_jax_package(cpu):
    """Same seed, same stream in each package, different streams across
    them (torch Philox against JAX's rbg/threefry)."""
    cpu.seed(3)
    paddle_tpu.seed(3)
    a, b = cpu.rand([64]).numpy(), np.asarray(paddle_tpu.rand([64]).numpy())
    assert not np.allclose(a, b)
    assert abs(a.mean() - 0.5) < 0.15 and abs(b.mean() - 0.5) < 0.15


def test_tensors_are_torch_tensors_with_paddle_methods(cpu):
    p = cpu.nn.Linear(2, 3).weight
    assert isinstance(p, cpu.Parameter) and isinstance(p, torch.nn.Parameter)
    assert isinstance(p, cpu.Tensor) and p.stop_gradient is False
    # numpy() detaches (torch's raises on a tensor that needs a gradient)
    assert p.numpy().shape == (2, 3)
    # torch ops on a paddle Tensor return plain tensors; paddle ops wrap
    assert type(torch.add(p, 1)) is torch.Tensor
    assert type(cpu.add(p, p)) is cpu.Tensor
    # torch's calling form of a shared method name still works
    assert p.transpose(0, 1).shape == [3, 2]
    assert p.sum(-1, True).shape == [2, 1]
    assert p.max(dim=0).values.shape == [3]


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a GPU")
def test_no_device_and_no_gpu_raises():
    prev = placement.default()
    placement.set_default(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            paddle_tpu_torch.to_tensor([1.0])
        from paddle_tpu_torch.vision.models import LeNet
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LeNet()
    finally:
        placement.set_default(prev)


def test_enforce_taxonomy_and_op_hint_match(cpu):
    """The error classes are paddle_tpu's (names, codes, bases), and a
    failing op carries its paddle name in both packages."""
    import paddle_tpu.core.enforce as J
    import paddle_tpu_torch.core.enforce as T
    for name in T.__all__:
        t = getattr(T, name)
        if isinstance(t, type):
            j = getattr(J, name)
            assert t.code == j.code, name
            assert [b.__name__ for b in t.__mro__] == [
                b.__name__ for b in j.__mro__], name
    for p in (paddle_tpu, cpu):
        with pytest.raises(Exception, match=r"operator < add > error"):
            p.add(p.ones([2]), p.ones([3]))
