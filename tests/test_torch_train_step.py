"""paddle_tpu_torch training held to paddle_tpu's.

- The optimizer's pure update (AdamW with global-norm clip, Adam with
  coupled L2 decay, O2 master weights) against paddle_tpu's
  ``functional_update`` on the same seeded numpy params and grads.
- ``bench_bert``'s CPU configuration (bench.py:167: vocab 1000, hidden
  128, 2 layers, 4 heads, ffn 512, seq 128, batch 8), f32, dropout 0:
  5 ``TrainStep``s of the port's BERT against the JAX ``TrainStep`` over
  ``bench.build_model``, from the JAX model's weights.
"""
import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.optimizer.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu_torch import amp, jit, optimizer
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.testing.models import build_model, mlm_loss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_CFG = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512, seq=128,
               batch=8)


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arrays(seed, shapes, scale=1.0):
    r = np.random.RandomState(seed)
    return [(r.randn(*s) * scale).astype(np.float32) for s in shapes]


SHAPES = [(16, 8), (8,), (5, 3, 4), (1,)]


def _run_both(jax_opt, torch_opt, params, grads_per_step, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jp = [jnp.asarray(p, jdt) for p in params]
    tp = [torch.from_numpy(p).to(dtype) for p in params]
    js, ts = jax_opt.functional_init(jp), torch_opt.functional_init(tp)
    for step, grads in enumerate(grads_per_step, 1):
        jp, js = jax_opt.functional_update(
            jp, [jnp.asarray(g, jdt) for g in grads], js,
            jnp.float32(jax_opt.get_lr()), step)
        tp, ts = torch_opt.functional_update(
            tp, [torch.from_numpy(g).to(dtype) for g in grads], ts,
            torch_opt.get_lr(), step)
    return jp, js, tp, ts


@pytest.mark.parametrize("clip_norm", [1.0, 1e6], ids=["clipped",
                                                       "unclipped"])
def test_adamw_with_clip_matches_functional_update(clip_norm):
    """f32 params: rtol 1e-5 / atol 1e-7 over 3 steps (the same f32
    ops; bias corrections in f64 here, f32 there)."""
    params = _arrays(0, SHAPES)
    grads = [_arrays(s, SHAPES, 3.0) for s in (1, 2, 3)]
    kw = dict(learning_rate=1e-2, weight_decay=0.01)
    jp, js, tp, ts = _run_both(
        jopt.AdamW(grad_clip=JaxClip(clip_norm), **kw),
        optimizer.AdamW(grad_clip=optimizer.ClipGradByGlobalNorm(clip_norm),
                        **kw), params, grads, torch.float32)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(ts, js):
        for k in ("m", "v"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-5, atol=1e-9)


def test_adam_with_coupled_decay_matches_functional_update():
    params = _arrays(4, SHAPES)
    grads = [_arrays(s, SHAPES) for s in (5, 6)]
    kw = dict(learning_rate=1e-3, weight_decay=0.05)
    jp, _, tp, _ = _run_both(jopt.Adam(**kw), optimizer.Adam(**kw), params,
                             grads, torch.float32)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_o2_master_weights_match_functional_update():
    """bf16 params with f32 masters (multi_precision).  The masters agree
    to 2e-6 over 3 steps; the bf16 params are their casts, bit for bit.
    (paddle_tpu sums the clip's norm of bf16 grads in bf16, the port in
    f32: grads here stay below the clip, so the scale is 1 on both.)"""
    params = _arrays(7, SHAPES)
    grads = [_arrays(s, SHAPES, 0.05) for s in (8, 9, 10)]
    kw = dict(learning_rate=1e-2, weight_decay=0.01, multi_precision=True)
    jp, js, tp, ts = _run_both(
        jopt.AdamW(grad_clip=JaxClip(100.0), **kw),
        optimizer.AdamW(grad_clip=optimizer.ClipGradByGlobalNorm(100.0),
                        **kw), params, grads, torch.bfloat16)
    for a, b, sa, sb in zip(tp, jp, ts, js):
        assert a.dtype == torch.bfloat16 and sa["master"].dtype == \
            torch.float32
        np.testing.assert_allclose(sa["master"].numpy(),
                                   np.asarray(sb["master"]), rtol=0,
                                   atol=2e-6)
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(sb["master"].astype(
                jnp.bfloat16).astype(jnp.float32)))


def test_decorate_o2_casts_the_model_and_turns_on_master_weights():
    m = build_model(50, 16, 1, 2, 32, 8, 0.0, device="cpu")
    opt = optimizer.AdamW(parameters=m.parameters())
    m2, opt2 = amp.decorate(m, opt, level="O2", dtype="bfloat16")
    assert m2 is m and opt2 is opt and opt._multi_precision
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    # O1 casts nothing and only records the type; other levels raise
    m1 = build_model(50, 16, 1, 2, 32, 8, 0.0, device="cpu")
    assert amp.decorate(m1, level="O1") is m1
    assert all(p.dtype == torch.float32 for p in m1.parameters())
    assert m1._amp_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        amp.decorate(m1, opt, level="O3")


def test_train_step_raises_on_what_is_not_ported():
    """``scaler``, ``accumulate_steps``, ``recompute`` and ``amp_level``
    are ported: each trains the BERT a step to a finite loss.  What the
    JAX step refuses, this one refuses too: an ``accumulate_steps``
    below 1 or an ``amp_level`` other than O1 / O2."""
    x = torch.randint(0, 50, (2, 8),
                      generator=torch.Generator().manual_seed(0))
    for kw in ({"scaler": amp.GradScaler(init_loss_scaling=8.0)},
               {"accumulate_steps": 2}, {"recompute": True},
               {"amp_level": "O1"}):
        m = build_model(50, 16, 1, 2, 32, 8, 0.0, device="cpu")
        step = jit.TrainStep(m, mlm_loss(m), optimizer.AdamW(
            parameters=m.parameters()), **kw)
        assert math.isfinite(float(step(x, x)))
    for kw in ({"accumulate_steps": 0}, {"amp_level": "O3"}):
        with pytest.raises(ValueError):
            jit.TrainStep(m, mlm_loss(m), optimizer.AdamW(
                parameters=m.parameters()), **kw)


def test_train_step_draws_new_dropout_every_step():
    """Two steps on one batch at lr 0 see two dropout draws."""
    m = build_model(60, 32, 1, 2, 64, 16, 0.1, device="cpu")
    step = jit.TrainStep(m, mlm_loss(m), optimizer.AdamW(
        learning_rate=0.0, weight_decay=0.0, parameters=m.parameters()))
    x = torch.randint(0, 60, (2, 16))
    a, b = float(step(x, x)), float(step(x, x))
    assert a != b
    assert all(math.isfinite(v) for v in (a, b))


def test_bert_loss_trajectory_matches_the_jax_train_step():
    """Five steps of AdamW(lr 1e-4, wd 0.01) + global-norm clip 1.0 on
    bench.py's inputs.  Losses rtol 2e-5 (f32 forward and backward in
    another summation order, then Adam)."""
    c = CPU_CFG
    bench = _bench()
    paddle.seed(2024)
    jm = bench.build_model(c["vocab"], c["hidden"], c["layers"], c["heads"],
                           c["ffn"], c["seq"], 0.0)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    jo = jopt.AdamW(learning_rate=1e-4, parameters=jm.parameters(),
                    weight_decay=0.01, grad_clip=JaxClip(1.0))

    def jloss(out, labels):
        return JF.linear_cross_entropy(out.reshape([-1, c["hidden"]]),
                                       jm.head.weight, jm.head.bias,
                                       labels.reshape([-1]))

    jstep = JaxTrainStep(jm, jloss, jo, n_inputs=1)
    tm = build_model(c["vocab"], c["hidden"], c["layers"], c["heads"],
                     c["ffn"], c["seq"], 0.0, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(state, "cpu", model=tm))
    tstep = jit.TrainStep(tm, mlm_loss(tm), optimizer.AdamW(
        learning_rate=1e-4, parameters=tm.parameters(), weight_decay=0.01,
        grad_clip=optimizer.ClipGradByGlobalNorm(1.0)), n_inputs=1)
    rng = np.random.RandomState(0)
    x = rng.randint(0, c["vocab"], (c["batch"], c["seq"]), dtype=np.int32)
    y = rng.randint(0, c["vocab"], (c["batch"], c["seq"]), dtype=np.int32)
    jl = [float(jstep(jnp.asarray(x), jnp.asarray(y))) for _ in range(5)]
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    assert tl[-1] < tl[0]
    # the parameters moved alike: atol 2e-5, a fifth of one Adam step.
    # The key projection's bias is the exception: softmax ignores a shift
    # that is the same for every key, so its gradient is zero but for
    # rounding, and Adam moves it by up to lr a step on either side
    jw = jm.state_dict()
    for k, v in tm.state_dict().items():
        j = np.asarray(jw[k].numpy())
        if k.endswith("self_attn.k_proj.bias"):
            assert np.abs(v.numpy() - state[k]).max() <= 5 * 1e-4 * 1.01
            assert np.abs(j - state[k]).max() <= 5 * 1e-4 * 1.01
            continue
        np.testing.assert_allclose(v.numpy(), j, rtol=0, atol=2e-5,
                                   err_msg=k)


def test_eager_step_matches_the_train_step():
    """``loss.backward(); opt.step()`` and ``TrainStep`` take the same
    update (f32, dropout 0): parameters equal after two steps."""
    import copy
    m1 = build_model(80, 32, 1, 2, 64, 16, 0.0, device="cpu")
    m2 = copy.deepcopy(m1)
    kw = dict(learning_rate=1e-3, weight_decay=0.01,
              grad_clip=optimizer.ClipGradByGlobalNorm(0.5))
    o1 = optimizer.AdamW(parameters=m1.parameters(), **kw)
    step = jit.TrainStep(m2, mlm_loss(m2), optimizer.AdamW(
        parameters=m2.parameters(), **kw))
    x = torch.randint(0, 80, (2, 16), generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        mlm_loss(m1)(m1(x), x).backward()
        o1.step()
        o1.clear_grad()
        step(x, x)
    for (n, a), b in zip(m1.named_parameters(), m2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-7, err_msg=n)
    assert all(p.grad is None for p in m1.parameters())


def test_rng_seed_state_and_per_call_seeds():
    from paddle_tpu_torch.core import rng
    rng.seed(11)
    a = build_model(40, 16, 1, 2, 32, 8, 0.0, device="cpu").state_dict()
    first = [rng.next_seed() for _ in range(3)]
    state = rng.get_rng_state()
    nxt = rng.next_seed()
    rng.seed(11)
    b = build_model(40, 16, 1, 2, 32, 8, 0.0, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert [rng.next_seed() for _ in range(3)] == first
    assert len(set(first)) == 3
    rng.set_rng_state(state)
    assert rng.next_seed() == nxt


def _draws(rng):
    """3 host seeds and 3 device draws (the CPU's generator)."""
    bits = torch.randint(0, 2 ** 16, (3,), generator=rng.generator("cpu"))
    return [rng.next_seed() for _ in range(3)], bits.tolist()


def test_rng_fold_in_streams_are_per_key_and_resume():
    """The data-parallel step's streams: one per (seed, key), each apart
    from the others and from the seed's own, continued at the next
    entry; the seed's own stream is untouched by them."""
    from paddle_tpu_torch.core import rng
    rng.seed(11)
    own = _draws(rng)
    rng.seed(11)
    with rng.fold_in(0):
        k0 = _draws(rng)
    with rng.fold_in(1):
        k1 = _draws(rng)
    assert _draws(rng) == own
    with rng.fold_in(0):
        k0_next = _draws(rng)
    assert k0 != k1 and k0 != k0_next and k0 != own
    rng.seed(11)
    with rng.fold_in(0):
        assert _draws(rng) == k0
        assert _draws(rng) == k0_next
    rng.seed(12)
    with rng.fold_in(0):
        assert _draws(rng) != k0


def test_clip_of_bf16_grads_sums_the_norm_in_f32():
    """A difference from paddle_tpu, at bf16 only: paddle_tpu squares and
    sums bf16 grads in bf16 and returns bf16 clipped grads; the port sums
    in f32 and returns f32 grads (exact to f32 against a float64 norm),
    which agree with paddle_tpu's to bf16 rounding (rtol 2**-7)."""
    grads = _arrays(20, SHAPES, 4.0)
    tg = [torch.from_numpy(g).to(torch.bfloat16) for g in grads]
    got = [g for _, g in optimizer.ClipGradByGlobalNorm(1.0)(
        [(None, g) for g in tg])]
    exact = np.sqrt(sum((g.double() ** 2).sum().item() for g in tg))
    for g, c in zip(tg, got):
        assert c.dtype == torch.float32
        np.testing.assert_allclose(c.numpy(), g.double().numpy() / exact,
                                   rtol=1e-6, atol=1e-9)
    jg = [g for _, g in JaxClip(1.0)(
        [(None, jnp.asarray(g, jnp.bfloat16)) for g in grads])]
    for c, j in zip(got, jg):
        np.testing.assert_allclose(c.numpy(), np.asarray(j, np.float32),
                                   rtol=2 ** -7, atol=1e-6)
