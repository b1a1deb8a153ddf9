"""The norm functions and layers against paddle_tpu on the CPU.

The same seeded numpy inputs go through ``paddle_tpu`` and
``paddle_tpu_torch``; layers start from the JAX layer's state dict
(weights and running statistics).  Tolerances, stated once:

- f32: rtol 1e-5, atol 1e-5 (outputs, running statistics);
- bf16: rtol 2e-2, atol 3e-2 on outputs and running statistics.  The
  reference rounds to bf16 after each jnp op of ``(x - m) *
  rsqrt(v + eps) * w + b``; the port's batch norm computes in f32 and
  rounds once, so the two differ by a few bf16 ulps (2^-8 relative).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=3e-2)


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _x(shape, seed=0, scale=2.0, shift=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype("float32")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t.data.astype("float32"))


def _carry(jlayer, tlayer):
    state = {k: np.asarray(v.data) for k, v in jlayer.state_dict().items()}
    tlayer.set_state_dict(state_dict_from_paddle_tpu(state, device="cpu",
                                                     model=tlayer))


def _pair(cls_name, *args, seed=0, **kwargs):
    paddle_tpu.seed(seed)
    j = getattr(paddle_tpu.nn, cls_name)(*args, **kwargs)
    t = getattr(paddle_tpu_torch.nn, cls_name)(*args, **kwargs)
    _carry(j, t)
    return j, t


def _affine(c, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.rand(c).astype("float32") + 0.5,
            rs.randn(c).astype("float32"))


# -- functions ----------------------------------------------------------

BN_CASES = [
    # (shape, data_format, training, use_global_stats)
    ((8, 3, 5, 5), "NCHW", True, None),
    ((8, 3, 5, 5), "NCHW", False, None),
    ((8, 3, 5, 5), "NCHW", True, True),
    ((8, 5, 5, 3), "NHWC", True, None),
    ((8, 5, 5, 3), "NHWC", False, None),
    ((16, 3), "NCL", True, None),
    ((8, 3, 7), "NCL", True, None),
    ((8, 7, 3), "NLC", True, None),
    ((4, 3, 3, 4, 5), "NCDHW", True, None),
    ((4, 3, 4, 5, 3), "NDHWC", False, None),
]


@pytest.mark.parametrize("shape,fmt,training,global_stats", BN_CASES)
def test_batch_norm_function_matches(cpu, shape, fmt, training,
                                     global_stats):
    x = _x(shape)
    c = shape[1] if fmt.startswith("NC") else shape[-1]
    w, b = _affine(c)
    rm = np.random.RandomState(2).randn(c).astype("float32")
    rv = np.random.RandomState(3).rand(c).astype("float32") + 0.5
    j = JF.batch_norm(paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(rm),
                      paddle_tpu.to_tensor(rv), paddle_tpu.to_tensor(w),
                      paddle_tpu.to_tensor(b), training=training,
                      data_format=fmt, use_global_stats=global_stats)
    t = TF.batch_norm(cpu.to_tensor(x), cpu.to_tensor(rm), cpu.to_tensor(rv),
                      cpu.to_tensor(w), cpu.to_tensor(b), training=training,
                      data_format=fmt, use_global_stats=global_stats)
    np.testing.assert_allclose(_np(t), _np(j), **F32)


def test_batch_norm_statistics_from_the_op_match_var_mean(cpu):
    """The training op's saved mean and inverse std give the batch's
    biased variance as ``torch.var_mean`` does, with the activation
    read once."""
    x = cpu.to_tensor(_x((32, 16, 7, 7), scale=3.0, shift=2.0))
    out, mean, var = TF.norm._batch_norm(x, None, None, None, None, True,
                                         1e-5, "NCHW", True)
    ref_var, ref_mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(mean.numpy(), ref_mean.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), ref_var.numpy(), rtol=1e-5)
    tiny = cpu.to_tensor(_x((64, 4), scale=1e-3, shift=0.5))
    _, _, var = TF.norm._batch_norm(tiny, None, None, None, None, True,
                                    1e-5, "NCHW", True)
    np.testing.assert_allclose(
        var.numpy(), torch.var(tiny, 0, unbiased=False).numpy(), rtol=1e-3)


@pytest.mark.parametrize("fmt,affine", [("NCHW", "wb"), ("NHWC", "wb"),
                                        ("NCHW", "w"), ("NCHW", "")])
def test_group_norm_function_matches(cpu, fmt, affine):
    shape = (4, 6, 5, 5) if fmt == "NCHW" else (4, 5, 5, 6)
    x = _x(shape)
    w, b = _affine(6)
    jw = paddle_tpu.to_tensor(w) if "w" in affine else None
    jb = paddle_tpu.to_tensor(b) if "b" in affine else None
    tw = cpu.to_tensor(w) if "w" in affine else None
    tb = cpu.to_tensor(b) if "b" in affine else None
    j = JF.group_norm(paddle_tpu.to_tensor(x), 3, 1e-5, jw, jb, fmt)
    t = TF.group_norm(cpu.to_tensor(x), 3, 1e-5, tw, tb, fmt)
    np.testing.assert_allclose(_np(t), _np(j), **F32)


@pytest.mark.parametrize("shape", [(4, 3, 9), (4, 3, 5, 5),
                                   (2, 3, 3, 4, 5)])
def test_instance_norm_function_matches(cpu, shape):
    x = _x(shape)
    w, b = _affine(3)
    j = JF.instance_norm(paddle_tpu.to_tensor(x),
                         weight=paddle_tpu.to_tensor(w),
                         bias=paddle_tpu.to_tensor(b), eps=1e-5)
    t = TF.instance_norm(cpu.to_tensor(x), weight=cpu.to_tensor(w),
                         bias=cpu.to_tensor(b), eps=1e-5)
    np.testing.assert_allclose(_np(t), _np(j), **F32)


@pytest.mark.parametrize("size", [3, 4, 5])
def test_local_response_norm_function_matches(cpu, size):
    x = _x((2, 7, 4, 4))
    j = JF.local_response_norm(paddle_tpu.to_tensor(x), size, 1e-2, 0.75,
                               2.0)
    t = TF.local_response_norm(cpu.to_tensor(x), size, 1e-2, 0.75, 2.0)
    np.testing.assert_allclose(_np(t), _np(j), **F32)


# -- layers ------------------------------------------------------------

LAYER_CASES = [
    # (class, ctor args, ctor kwargs, input shape)
    ("BatchNorm2D", (3,), {}, (8, 3, 5, 5)),
    ("BatchNorm2D", (3,), {"momentum": 0.5}, (8, 3, 5, 5)),
    ("BatchNorm2D", (3,), {"data_format": "NHWC"}, (8, 5, 5, 3)),
    ("BatchNorm2D", (3,), {"use_global_stats": True}, (8, 3, 5, 5)),
    ("BatchNorm2D", (3,), {"weight_attr": False, "bias_attr": False},
     (8, 3, 5, 5)),
    ("BatchNorm1D", (4,), {}, (16, 4)),
    ("BatchNorm1D", (4,), {"momentum": 0.8}, (8, 4, 6)),
    ("BatchNorm3D", (3,), {}, (4, 3, 3, 4, 5)),
    ("BatchNorm", (3,), {"act": "relu"}, (8, 3, 5, 5)),
    ("SyncBatchNorm", (3,), {}, (8, 3, 5, 5)),
]


@pytest.mark.parametrize("name,args,kwargs,shape", LAYER_CASES)
def test_batch_norm_layers_match_in_train_and_eval(cpu, name, args, kwargs,
                                                   shape):
    """Three training forwards (the running statistics move each time,
    by the layer's momentum and the biased variance), then eval."""
    j, t = _pair(name, *args, **kwargs)
    j.train(), t.train()
    for step in range(3):
        x = _x(shape, seed=step)
        np.testing.assert_allclose(_np(t(cpu.to_tensor(x))),
                                   _np(j(paddle_tpu.to_tensor(x))), **F32)
        np.testing.assert_allclose(_np(t._mean), _np(j._mean), **F32)
        np.testing.assert_allclose(_np(t._variance), _np(j._variance),
                                   **F32)
    j.eval(), t.eval()
    x = _x(shape, seed=9)
    np.testing.assert_allclose(_np(t(cpu.to_tensor(x))),
                               _np(j(paddle_tpu.to_tensor(x))), **F32)


def test_batchnorm_train_eval_twin(cpu):
    """``tests/test_nn.py::test_batchnorm_train_eval`` on the port, and
    the same numbers as paddle_tpu's."""
    j, bn = _pair("BatchNorm2D", 3, momentum=0.5)
    x = _x((8, 3, 4, 4))
    bn.train(), j.train()
    yn = bn(cpu.to_tensor(x)).numpy()
    assert abs(yn.mean()) < 1e-5
    np.testing.assert_allclose(yn.var(axis=(0, 2, 3)), np.ones(3), rtol=1e-3)
    assert float(bn._mean.abs().sum()) > 0
    np.testing.assert_allclose(yn, _np(j(paddle_tpu.to_tensor(x))), **F32)
    bn.eval()
    assert not np.allclose(bn(cpu.to_tensor(x)).numpy(), yn)


def test_batch_norm_buffers_round_trip_by_name(cpu, tmp_path):
    """``_mean``/``_variance`` are persistable buffers under paddle_tpu's
    names: ``state_dict``, ``paddle.save``/``load`` and
    ``set_state_dict`` carry them both ways."""
    j, t = _pair("BatchNorm2D", 3)
    t.train()
    t(cpu.to_tensor(_x((8, 3, 4, 4))))
    state = t.state_dict()
    assert sorted(state) == sorted(j.state_dict()) == [
        "_mean", "_variance", "bias", "weight"]
    path = str(tmp_path / "bn.pdparams")
    cpu.save(state, path)
    j.set_state_dict(paddle_tpu.load(path))
    np.testing.assert_array_equal(_np(j._mean), _np(t._mean))
    fresh = cpu.nn.BatchNorm2D(3)
    fresh.set_state_dict(cpu.load(path))
    np.testing.assert_array_equal(fresh._variance.numpy(),
                                  t._variance.numpy())


def test_to_dtype_casts_buffers_and_keeps_them_paddle_tensors(cpu):
    """``Layer.to(dtype=)`` casts running statistics too (paddle_tpu's
    ``to``), and they stay paddle Tensors."""
    bn = cpu.nn.BatchNorm2D(3)
    bn.to(dtype="bfloat16")
    for buf in (bn._mean, bn._variance, bn.weight):
        assert buf.dtype == torch.bfloat16
    assert isinstance(bn._mean, cpu.Tensor)
    assert bn.state_dict()["_mean"].dtype == torch.bfloat16


@pytest.mark.parametrize("shape,fmt", [((8, 3, 5, 5), "NCHW"),
                                       ((8, 5, 5, 3), "NHWC")])
def test_batch_norm_bf16_matches(cpu, shape, fmt):
    """bf16 parameters, buffers and input (what O2 ``decorate`` makes):
    outputs and running statistics within the bf16 tolerance."""
    j, t = _pair("BatchNorm2D", 3, data_format=fmt)
    j.to(dtype="bfloat16"), t.to(dtype="bfloat16")
    j.train(), t.train()
    for step in range(2):
        x = _x(shape, seed=step)
        jo = j(paddle_tpu.to_tensor(x).astype("bfloat16"))
        to = t(cpu.to_tensor(x).astype("bfloat16"))
        assert to.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(to), _np(jo), **BF16)
        assert t._mean.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(t._mean), _np(j._mean), **BF16)
        np.testing.assert_allclose(_np(t._variance), _np(j._variance),
                                   **BF16)


OTHER_LAYERS = [
    ("GroupNorm", (2, 6), {}, (4, 6, 5, 5)),
    ("GroupNorm", (3, 6), {"data_format": "NHWC"}, (4, 5, 5, 6)),
    ("InstanceNorm1D", (3,), {}, (4, 3, 9)),
    ("InstanceNorm2D", (3,), {}, (4, 3, 5, 5)),
    ("InstanceNorm3D", (3,), {}, (2, 3, 3, 4, 5)),
    ("LocalResponseNorm", (3,), {}, (2, 7, 4, 4)),
    ("LayerNorm", (5,), {}, (4, 3, 5)),
]


@pytest.mark.parametrize("name,args,kwargs,shape", OTHER_LAYERS)
def test_other_norm_layers_match(cpu, name, args, kwargs, shape):
    j, t = _pair(name, *args, **kwargs)
    x = _x(shape)
    np.testing.assert_allclose(_np(t(cpu.to_tensor(x))),
                               _np(j(paddle_tpu.to_tensor(x))), **F32)


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 3)])
def test_spectral_norm_matches(cpu, dim, iters):
    j, t = _pair("SpectralNorm", [6, 4, 3], dim=dim, power_iters=iters)
    assert sorted(t.state_dict()) == ["weight_u", "weight_v"]
    assert t.weight_u.stop_gradient
    w = _x((6, 4, 3))
    np.testing.assert_allclose(_np(t(cpu.to_tensor(w))),
                               _np(j(paddle_tpu.to_tensor(w))), **F32)


def test_sync_batch_norm_is_batch_norm_at_world_size_one(cpu):
    """At world size 1 the reference's SyncBatchNorm is its BatchNorm
    (GSPMD's global batch is the one batch), and
    ``convert_sync_batchnorm`` returns the layer as it is."""
    net = cpu.nn.Sequential(cpu.nn.Conv2D(3, 3, 1), cpu.nn.BatchNorm2D(3))
    assert cpu.nn.SyncBatchNorm.convert_sync_batchnorm(net) is net
    assert paddle_tpu.nn.SyncBatchNorm.convert_sync_batchnorm(net) is net
    _, sync = _pair("SyncBatchNorm", 3, seed=4)
    _, plain = _pair("BatchNorm2D", 3, seed=4)
    x = cpu.to_tensor(_x((8, 3, 4, 4)))
    np.testing.assert_array_equal(sync(x).numpy(), plain(x).numpy())
    np.testing.assert_array_equal(sync._variance.numpy(),
                                  plain._variance.numpy())
