"""paddle_tpu_torch.nn held to paddle_tpu.nn.

Each layer is built on both sides, the JAX layer's weights (set to
seeded numpy values) are carried across by
``state_dict_from_paddle_tpu``, and the same numpy inputs go through
both.  f32 throughout; rtol 1e-5 / atol 1e-5 (the same f32 math, summed
in another order by XLA and by PyTorch's CPU kernels)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.nn import functional as TF

RTOL = ATOL = 1e-5


def _randomise(jlayer, seed):
    """Seeded numpy values for every JAX parameter; returns them."""
    r = np.random.RandomState(seed)
    state = {k: (r.randn(*v.shape) * 0.3).astype(np.float32)
             for k, v in jlayer.state_dict().items()}
    jlayer.set_state_dict(state)
    return state


def _carry(jlayer, tlayer, seed):
    state = _randomise(jlayer, seed)
    tlayer.load_state_dict(state_dict_from_paddle_tpu(state, "cpu",
                                                      model=tlayer))
    return state


def _close(a, b, rtol=RTOL, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    b = b.numpy() if hasattr(b, "numpy") else np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_linear_keeps_the_in_out_layout():
    j, t = jnn.Linear(8, 16), tnn.Linear(8, 16, device="cpu")
    _carry(j, t, 0)
    assert tuple(t.weight.shape) == (8, 16)
    x = _x(1, 3, 5, 8)
    _close(t(torch.from_numpy(x)), j(paddle.to_tensor(x)))
    assert tnn.Linear(8, 4, bias_attr=False, device="cpu").bias is None


def test_embedding_and_padding_rows():
    ids = np.array([[0, 3, 9], [9, 1, 0]], np.int32)
    for pad in (None, 9):
        j = jnn.Embedding(10, 6, padding_idx=pad)
        t = tnn.Embedding(10, 6, padding_idx=pad, device="cpu")
        _carry(j, t, 2)
        _close(t(torch.from_numpy(ids)), j(paddle.to_tensor(ids)),
               rtol=0, atol=0)


def test_layer_norm_and_gelu():
    j, t = jnn.LayerNorm(12), tnn.LayerNorm(12, device="cpu")
    _carry(j, t, 3)
    x = _x(4, 2, 7, 12) * 3 + 1
    _close(t(torch.from_numpy(x)), j(paddle.to_tensor(x)))
    for approximate in (False, True):
        _close(TF.gelu(torch.from_numpy(x), approximate),
               JF.gelu(paddle.to_tensor(x), approximate))


@pytest.mark.parametrize("mask", [None, "bool"])
def test_multi_head_attention(mask):
    """The flash path (no mask) and the unfused path (a boolean mask)."""
    j = jnn.MultiHeadAttention(32, 4)
    t = tnn.MultiHeadAttention(32, 4, device="cpu")
    _carry(j, t, 5)
    q, kv = _x(6, 2, 9, 32), _x(7, 2, 11, 32)
    m = None
    if mask:
        m = np.random.RandomState(8).rand(2, 4, 9, 11) > 0.3
        m[..., 0] = True                     # no row fully masked
    j.eval()
    t.eval()
    got = t(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
            attn_mask=None if m is None else torch.from_numpy(m))
    want = j(paddle.to_tensor(q), paddle.to_tensor(kv), paddle.to_tensor(kv),
             attn_mask=None if m is None else paddle.to_tensor(m))
    _close(got, want)


def test_unfused_attention_returns_the_weights():
    q, k, v = (_x(s, 2, 6, 3, 8) for s in (9, 10, 11))
    out, w = TF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True,
        return_weights=True)
    jout, jw = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), is_causal=True,
        return_weights=True)
    _close(out, jout)
    _close(w, jw)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_encoder(normalize_before):
    """Two layers with different weights each, GELU, dropout 0."""
    kw = dict(dropout=0.0, activation="gelu",
              normalize_before=normalize_before)
    j = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(32, 4, 64, **kw),
                               2)
    t = tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(32, 4, 64, device="cpu", **kw), 2)
    state = _carry(j, t, 12)
    assert list(t.state_dict()) == list(state)
    x = _x(13, 2, 10, 32)
    _close(t(torch.from_numpy(x)), j(paddle.to_tensor(x)))


def test_state_dict_transfer_checks_names_and_keeps_bf16_bits():
    j = jnn.Linear(4, 3)
    t = tnn.Linear(4, 3, device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_paddle_tpu({"weight": state["weight"]}, "cpu",
                                   model=t)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_paddle_tpu({"weight": state["weight"].T,
                                    "bias": state["bias"]}, "cpu", model=t)
    j.bfloat16()
    bf = {k: np.asarray(v.data) for k, v in j.state_dict().items()}
    got = state_dict_from_paddle_tpu(bf, "cpu")
    assert got["weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["weight"].view(torch.int16).numpy(),
                                  bf["weight"].view(np.int16))


def test_dropout_u16_rule():
    x = torch.ones(64, 256)
    assert TF.dropout(x, 0.0) is x
    assert TF.dropout(x, 0.5, training=False) is x
    _close(TF.dropout(x, 0.25, training=False, mode="downscale_in_infer"),
           np.full((64, 256), 0.75, np.float32))
    y = TF.dropout(x, 0.1)
    kept = (y != 0).float().mean().item()
    sigma = math.sqrt(0.09 / y.numel())
    assert abs(kept - (1 - 6554 / 65536)) < 4 * sigma
    assert torch.all((y == 0) | (y == 65536.0 / (65536 - 6554)))
    assert not TF.dropout(x, 1.0).any()
    y = TF.dropout(x, 0.5, axis=1)            # one draw per column
    assert torch.all(y == y[:1])


def test_cross_entropy_with_ignore_index_weights_and_smoothing():
    logits = _x(14, 6, 5)
    lab = np.array([0, 4, -100, 2, 2, 1], np.int64)
    w = np.abs(_x(15, 5)) + 0.1
    for kw in ({}, {"weight": w}, {"label_smoothing": 0.1},
               {"reduction": "sum"}, {"reduction": "none"}):
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        _close(TF.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(lab), **tkw),
               JF.cross_entropy(paddle.to_tensor(logits),
                                paddle.to_tensor(lab), **jkw))


def test_linear_cross_entropy_value_and_grads():
    """Chunked head + CE (T=37 rows in chunks of 8 -> 5 chunks of 8,
    the last one short) against paddle_tpu's ``_linear_ce_fn`` and
    ``jax.grad`` of it."""
    from paddle_tpu.nn.functional import _linear_ce_fn
    h, wt, b = _x(16, 37, 12), _x(17, 12, 50), _x(18, 50)
    lab = np.random.RandomState(19).randint(0, 50, 37).astype(np.int32)
    lab[[3, 20]] = -100

    def jloss(h, w, b):
        return _linear_ce_fn(h, w, b, jnp.asarray(lab), chunk=8,
                             ignore_index=-100)

    jval, jg = jax.value_and_grad(jloss, (0, 1, 2))(
        *(jnp.asarray(a) for a in (h, wt, b)))
    th, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (h, wt, b))
    val = TF.linear_cross_entropy(th, tw, tb, torch.from_numpy(lab),
                                  chunk=8)
    tg = torch.autograd.grad(val, (th, tw, tb))
    _close(val, np.asarray(jval))
    for a, bb in zip(tg, jg):
        _close(a, np.asarray(bb))
    dense = TF.cross_entropy(th @ tw + tb, torch.from_numpy(lab).long())
    _close(val, dense.detach().numpy())
