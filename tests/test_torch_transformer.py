"""The decoder family of ``nn.Transformer`` on both packages on the CPU:
``TransformerDecoderLayer`` (pre- and post-norm), ``TransformerDecoder``
and ``Transformer``, forward and backward, from the same weights
(carried by ``state_dict`` through ``state_dict_from_paddle_tpu``) and
the same seeded numpy inputs; f32 within 1e-5.  The caches: the
incremental decode (one target position a step through ``gen_cache``'s
``(Cache, StaticCache)`` pairs) against the full forward under
``generate_square_subsequent_mask``, position by position, on both
packages.  ``cuda`` tests hold the card's incremental decode (the flash
forward at one query against the cache) to the CPU's, and that forward
alone to its plain version at odd key lengths and every head dim."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu

D, H, FFN = 32, 4, 64
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield paddle_tpu_torch
    placement.set_default(prev)


def _carry(jax_layer, port_layer, device="cpu"):
    sd = {k: np.asarray(v.data) for k, v in jax_layer.state_dict().items()}
    port_layer.set_state_dict(state_dict_from_paddle_tpu(sd, device,
                                                         port_layer))


def _inputs(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _grads(layer):
    return {k: p.grad.numpy() for k, p in layer.named_parameters()}


def _fwd_bwd(pkg, layer, args, weight):
    """Output and every parameter's gradient of sum(out * weight)."""
    ts = [pkg.to_tensor(a) if isinstance(a, np.ndarray) else a
          for a in args]
    out = layer(*ts)
    (out * pkg.to_tensor(weight)).sum().backward()
    return out.numpy(), _grads(layer)


def _assert_same(jax_res, port_res):
    np.testing.assert_allclose(port_res[0], jax_res[0], **TOL)
    assert sorted(port_res[1]) == sorted(jax_res[1])
    for k in jax_res[1]:
        np.testing.assert_allclose(port_res[1][k], jax_res[1][k],
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post-norm", "pre-norm"])
def test_decoder_layer_forward_and_backward(cpu, normalize_before):
    paddle_tpu.seed(1)
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    jl = paddle_tpu.nn.TransformerDecoderLayer(D, H, FFN, **kw)
    tl = paddle_tpu_torch.nn.TransformerDecoderLayer(D, H, FFN, **kw)
    _carry(jl, tl)
    tgt, mem, w = _inputs(2, (2, 6, D), (2, 5, D), (2, 6, D))
    jmask = paddle_tpu.nn.Transformer.generate_square_subsequent_mask(6)
    tmask = paddle_tpu_torch.nn.Transformer.generate_square_subsequent_mask(
        6)
    _assert_same(_fwd_bwd(paddle_tpu, jl, [tgt, mem, jmask], w),
                 _fwd_bwd(paddle_tpu_torch, tl, [tgt, mem, tmask], w))


def test_decoder_stack_with_norm_forward_and_backward(cpu):
    paddle_tpu.seed(2)
    stacks = []
    for pkg in (paddle_tpu, paddle_tpu_torch):
        layer = pkg.nn.TransformerDecoderLayer(D, H, FFN, dropout=0.0,
                                               normalize_before=True)
        stacks.append(pkg.nn.TransformerDecoder(layer, 3,
                                                pkg.nn.LayerNorm(D)))
    _carry(*stacks)
    assert list(stacks[1].state_dict()) == list(stacks[0].state_dict())
    tgt, mem, w = _inputs(3, (2, 4, D), (2, 7, D), (2, 4, D))
    _assert_same(_fwd_bwd(paddle_tpu, stacks[0], [tgt, mem], w),
                 _fwd_bwd(paddle_tpu_torch, stacks[1], [tgt, mem], w))


def test_decoder_layers_are_deep_copies(cpu):
    layer = paddle_tpu_torch.nn.TransformerDecoderLayer(D, H, FFN)
    dec = paddle_tpu_torch.nn.TransformerDecoder(layer, 2)
    a, b = dec.layers[0].linear1.weight, dec.layers[1].linear1.weight
    assert dec.layers[0] is layer and a is not b
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post-norm", "pre-norm"])
def test_transformer_forward_and_backward(cpu, normalize_before):
    paddle_tpu.seed(3)
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FFN, dropout=0.0,
              normalize_before=normalize_before)
    jm = paddle_tpu.nn.Transformer(**kw)
    tm = paddle_tpu_torch.nn.Transformer(**kw)
    assert list(tm.state_dict()) == list(jm.state_dict())
    _carry(jm, tm)
    src, tgt, w = _inputs(4, (3, 5, D), (3, 6, D), (3, 6, D))
    jmask = paddle_tpu.nn.Transformer.generate_square_subsequent_mask(6)
    tmask = paddle_tpu_torch.nn.Transformer.generate_square_subsequent_mask(
        6)
    _assert_same(_fwd_bwd(paddle_tpu, jm, [src, tgt, None, jmask], w),
                 _fwd_bwd(paddle_tpu_torch, tm, [src, tgt, None, tmask], w))


def test_square_subsequent_mask_is_zero_and_minus_inf(cpu):
    j = np.asarray(paddle_tpu.nn.Transformer.generate_square_subsequent_mask(
        5).numpy())
    t = paddle_tpu_torch.nn.Transformer.generate_square_subsequent_mask(5)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), j)
    assert np.isneginf(t.numpy()[0, 1]) and t.numpy()[1, 0] == 0.0


def test_custom_encoder_and_decoder(cpu):
    enc = paddle_tpu_torch.nn.TransformerEncoder(
        paddle_tpu_torch.nn.TransformerEncoderLayer(D, H, FFN, 0.0), 1)
    dec = paddle_tpu_torch.nn.TransformerDecoder(
        paddle_tpu_torch.nn.TransformerDecoderLayer(D, H, FFN, 0.0), 1)
    tm = paddle_tpu_torch.nn.Transformer(D, H, custom_encoder=enc,
                                         custom_decoder=dec)
    assert tm.encoder is enc and tm.decoder is dec
    src, tgt = _inputs(5, (1, 3, D), (1, 2, D))
    out = tm(paddle_tpu_torch.to_tensor(src), paddle_tpu_torch.to_tensor(tgt))
    assert out.shape == [1, 2, D]


def _incremental(pkg, model, src, tgt, do_zip):
    """Each target position through the decoder with its caches; the
    outputs concatenated over positions."""
    memory = model.encoder(pkg.to_tensor(src))
    cache = model.decoder.gen_cache(memory, do_zip=do_zip)
    if do_zip:
        assert len(cache) == 2
        assert all(isinstance(c, pkg.nn.MultiHeadAttention.Cache)
                   for c in cache[0])
        assert all(isinstance(c, pkg.nn.MultiHeadAttention.StaticCache)
                   for c in cache[1])
        cache = list(zip(*cache))
    outs = []
    for t in range(tgt.shape[1]):
        out, cache = model.decoder(pkg.to_tensor(tgt[:, t:t + 1]), memory,
                                   cache=cache)
        outs.append(out.numpy())
    assert cache[0][0].k.shape[1] == tgt.shape[1]
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("do_zip", [False, True])
def test_incremental_decode_equals_the_full_masked_forward(cpu, do_zip):
    paddle_tpu.seed(4)
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FFN, dropout=0.0)
    jm = paddle_tpu.nn.Transformer(**kw)
    tm = paddle_tpu_torch.nn.Transformer(**kw)
    _carry(jm, tm)
    src, tgt = _inputs(6, (2, 7, D), (2, 5, D))
    full = tm(paddle_tpu_torch.to_tensor(src),
              paddle_tpu_torch.to_tensor(tgt),
              tgt_mask=tm.generate_square_subsequent_mask(5)).numpy()
    inc = _incremental(paddle_tpu_torch, tm, src, tgt, do_zip)
    np.testing.assert_allclose(inc, full, **TOL)
    j_inc = _incremental(paddle_tpu, jm, src, tgt, do_zip)
    np.testing.assert_allclose(inc, j_inc, **TOL)


@pytest.mark.cuda
def test_cuda_incremental_decode_matches_the_cpu():
    """The card's incremental decode (self-attention at one query over a
    cache of t keys and cross-attention over 37 source positions, both
    through the f32 flash forward at D 64) against the CPU's, and the
    forward kernel launched twice a layer and step (and once by the
    encoder)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.ops.cuda import support
    paddle_tpu_torch.seed(5)
    kw = dict(d_model=256, nhead=4, num_encoder_layers=1,
              num_decoder_layers=2, dim_feedforward=512, dropout=0.0)
    cpu_model = paddle_tpu_torch.nn.Transformer(device="cpu", **kw)
    card = paddle_tpu_torch.nn.Transformer(device="cuda", **kw)
    card.set_state_dict({k: v.cuda() for k, v in
                         cpu_model.state_dict().items()})
    src, tgt = _inputs(7, (3, 37, 256), (3, 9, 256))
    outs = {}
    for where, model in (("cpu", cpu_model), ("cuda", card)):
        prev = placement.default()
        paddle_tpu_torch.set_device("gpu" if where == "cuda" else "cpu")
        try:
            support.reset_launch_counts()
            outs[where] = _incremental(paddle_tpu_torch, model, src, tgt,
                                       False)
            launches = dict(support.launch_counts)
        finally:
            placement.set_default(prev)
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], rtol=2e-5,
                               atol=2e-5)
    assert launches == {"flash_attention_fwd": 1 + 2 * 2 * 9}


@pytest.mark.cuda
@pytest.mark.parametrize("lk", [1, 37, 64, 200])
@pytest.mark.parametrize("head_dim", [32, 64, 96, 128])
def test_cuda_flash_forward_at_one_query(lk, head_dim):
    """The f32 flash forward at one query (an incremental decode's
    attention) against its plain version: out and lse within 2e-5, at
    odd and short key lengths and every compiled head dim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.ops.cuda import flash_attention_fwd
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_reference_fwd)
    rs = np.random.RandomState(lk * 7 + head_dim)
    q = torch.from_numpy(rs.randn(5, 1, 3, head_dim).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(5, lk, 3, head_dim).astype(
        np.float32)) for _ in range(2))
    scale = head_dim ** -0.5
    out, lse = flash_attention_fwd(q.cuda(), k.cuda(), v.cuda(),
                                   scale=scale)
    ro, rlse = flash_attention_reference_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        scale=scale)
    np.testing.assert_allclose(out.cpu().transpose(1, 2).numpy(),
                               ro.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.numpy(), rtol=2e-5,
                               atol=2e-5)
