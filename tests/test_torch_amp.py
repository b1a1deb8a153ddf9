"""The port's ``amp`` held to paddle_tpu's: ``auto_cast``'s cast hook
gives every op the output type paddle_tpu's hook gives it, at O1 and
O2 and with custom lists; ``decorate`` at O1 and O2; the eager
``GradScaler`` over a sequence with overflows."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp, nn, optimizer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.testing.models import build_model


def _inputs():
    r = np.random.RandomState(0)
    return dict(x=r.randn(2, 8, 2, 32).astype(np.float32),
                w=r.randn(32, 8).astype(np.float32),
                b=np.zeros(8, np.float32),
                h=r.randn(6, 32).astype(np.float32),
                lab=np.arange(6, dtype=np.int32),
                ids=np.arange(4, dtype=np.int32))


# op -> (paddle_tpu call, the port's call), on the arrays of _inputs
OPS = {
    "linear": (lambda P, F, a: F.linear(a["h"], a["w"], a["b"])),
    "embedding": (lambda P, F, a: F.embedding(a["ids"], a["w"])),
    "layer_norm": (lambda P, F, a: F.layer_norm(a["h"], [32])),
    "gelu": (lambda P, F, a: F.gelu(a["h"])),
    "relu": (lambda P, F, a: F.relu(a["h"])),
    "dropout": (lambda P, F, a: F.dropout(a["x"], 0.1)),
    "scaled_dot_product_attention": (
        lambda P, F, a: F.scaled_dot_product_attention(a["x"], a["x"],
                                                       a["x"])),
    "cross_entropy": (lambda P, F, a: F.cross_entropy(a["h"], a["lab"])),
    "mse_loss": (lambda P, F, a: F.mse_loss(a["h"], a["h"])),
    "linear_cross_entropy": (
        lambda P, F, a: F.linear_cross_entropy(a["h"], a["w"], a["b"],
                                               a["lab"])),
    "transpose": (lambda P, F, a: P.transpose(a["x"], [1, 0, 2, 3])),
}

CASES = {
    "O1": dict(level="O1"),
    "O2": dict(level="O2"),
    "O1-custom": dict(level="O1", custom_white_list={"gelu", "relu"},
                      custom_black_list={"linear"}),
    "O2-custom": dict(level="O2", custom_black_list={"gelu", "dropout"}),
    "off": dict(enable=False),
}


def _dtypes(P, Fmod, amp_mod, wrap, kw):
    a = {k: wrap(v) for k, v in _inputs().items()}
    with amp_mod.auto_cast(**kw):
        return {n: str(op(P, Fmod, a).dtype).replace("torch.", "")
                for n, op in OPS.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_cast_gives_each_op_the_jax_hooks_type(case):
    kw = CASES[case]
    jax_types = _dtypes(paddle, JF, jamp, paddle.to_tensor, kw)
    port_types = _dtypes(ptt, F, amp, torch.from_numpy, kw)
    assert port_types == jax_types
    if case == "O1":
        assert port_types["linear"] == "bfloat16"
        assert port_types["gelu"] == "float32"


def test_auto_cast_is_off_outside_the_block_and_nests():
    h = torch.randn(4, 8)
    w = torch.randn(8, 8)
    with amp.auto_cast(level="O1"):
        assert amp.amp_active()
        with amp.amp_guard(enable=False):
            assert F.linear(h, w).dtype == torch.float32
        assert F.linear(h, w).dtype == torch.bfloat16
    assert not amp.amp_active()
    assert F.linear(h, w).dtype == torch.float32
    with pytest.raises(ValueError):
        amp.auto_cast(level="O3")


def test_auto_cast_leaves_static_variables_to_the_program():
    """A static Variable is recorded as it is (f32), never cast."""
    from paddle_tpu_torch import static
    ptt.set_device("cpu")
    try:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4, 8], "float32")
            lin = nn.Linear(8, 8, device="cpu")
            with amp.auto_cast(level="O2"):
                y = lin(x)
        assert type(y).__name__ == "Variable"
        assert main.nodes[-1].op_name == "linear"
    finally:
        from paddle_tpu_torch.core import placement
        placement.set_default(None)


def test_decorate_o1_casts_nothing_and_records_the_type():
    m = build_model(50, 16, 1, 2, 32, 8, 0.0, device="cpu")
    opt = optimizer.AdamW(parameters=m.parameters())
    m2, opt2 = amp.decorate(m, opt, level="O1", dtype="bfloat16")
    assert m2 is m and opt2 is opt and not opt._multi_precision
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert m._amp_dtype == torch.bfloat16


def test_eager_grad_scaler_matches_jax_over_overflows():
    """``scale(loss).backward(); step(opt); update()`` for 6 steps, the
    2nd and 5th overflowing: the scale after every update equals
    paddle_tpu's, skipped steps change nothing, and the weights end
    within 1e-4 of one Adam step of paddle_tpu's (bias corrections in
    f32 there, f64 here)."""
    r = np.random.RandomState(3)
    x = r.randn(8, 4).astype(np.float32)
    y = r.randn(8, 2).astype(np.float32)
    bad = y.copy()
    bad[1, 1] = np.inf
    labels = [y, bad, y, y, bad, y]
    kw = dict(init_loss_scaling=16.0, incr_every_n_steps=2)
    paddle.seed(3)
    jnet = jnn.Linear(4, 2)
    net = nn.Linear(4, 2, device="cpu")
    with torch.no_grad():
        net.weight.copy_(torch.tensor(np.asarray(jnet.weight.numpy())))
        net.bias.copy_(torch.tensor(np.asarray(jnet.bias.numpy())))
    jo = jopt.Adam(learning_rate=0.05, parameters=jnet.parameters())
    to = optimizer.Adam(learning_rate=0.05, parameters=net.parameters())
    js, ts = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    jscales, tscales = [], []
    for lab in labels:
        jl = JF.mse_loss(jnet(paddle.to_tensor(x)), paddle.to_tensor(lab))
        js.scale(jl).backward()
        js.step(jo)
        js.update()
        jo.clear_grad()
        jscales.append(js._scale)
        w0 = net.weight.detach().clone()
        tl = F.mse_loss(net(torch.from_numpy(x)), torch.from_numpy(lab))
        ts.scale(tl).backward()
        ts.step(to)
        ts.update()
        to.clear_grad()
        tscales.append(ts._scale)
        if lab is bad:
            assert torch.equal(net.weight.detach(), w0)
    assert tscales == jscales == [16.0, 8.0, 8.0, 16.0, 8.0, 8.0]
    assert to._step_count == jo._step_count == 4
    for a, b in ((net.weight, jnet.weight), (net.bias, jnet.bias)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(
            b.numpy()), rtol=0, atol=1e-4 * 0.05)


def test_eager_unscale_once_then_step():
    """paddle_tpu's no-double-unscale rule: ``unscale_`` then ``step``
    divides the gradients once; a second ``unscale_`` before ``update``
    raises."""
    p = torch.nn.Parameter(torch.ones(2, 2))
    opt = optimizer.Adam(learning_rate=1.0, parameters=[p])
    sc = amp.GradScaler(init_loss_scaling=4.0)
    p.grad = torch.full((2, 2), 4.0)
    sc.unscale_(opt)
    assert torch.equal(p.grad, torch.ones(2, 2))
    sc.step(opt)
    sc.update()
    p.grad = torch.ones(2, 2)
    sc.unscale_(opt)
    with pytest.raises(RuntimeError):
        sc.unscale_(opt)
