"""The port's single-device GPT (``testing.models.build_gpt``) held to
``bench.build_gpt`` trained by paddle_tpu's ``TrainStep``.

``bench_gpt``'s CPU configuration (bench.py:341-343: vocab 1000, hidden
128, 2 layers, 4 heads, ffn 512, seq 128, batch 4), the tied head
through ``paddle.transpose`` / ``paddle.zeros`` /
``F.linear_cross_entropy``, AdamW(2e-4, wd 0.01) with global-norm clip
1.0.  Both models recompute every block.
"""
import copy
import importlib.util
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
from paddle_tpu_torch import jit, optimizer
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
from paddle_tpu_torch.testing.models import (GPT_PRESETS, build_gpt,
                                             gpt_flops_per_step,
                                             gpt_pretrain_loss)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_CFG = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512, seq=128,
               batch=4)


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch(c):
    r = np.random.RandomState(0)
    return tuple(r.randint(0, c["vocab"], (c["batch"], c["seq"]),
                           dtype=np.int32) for _ in range(2))


def _torch_step(model, c):
    return jit.TrainStep(model, gpt_pretrain_loss(model, c["vocab"]),
                         optimizer.AdamW(
                             learning_rate=2e-4,
                             parameters=model.parameters(),
                             weight_decay=0.01,
                             grad_clip=optimizer.ClipGradByGlobalNorm(1.0)))


def test_presets_and_flops_are_bench_gpts():
    bench = _bench()
    assert GPT_PRESETS == bench._GPT_PRESETS
    c = GPT_PRESETS["760m"]
    paddle.seed(0)
    jm = bench.build_gpt(**dict(c, layers=1))
    n_params = sum(int(np.prod(p.shape_tuple)) for p in jm.parameters())
    n_embed = (c["vocab"] + c["seq"]) * c["hidden"]
    n_matmul = (n_params - n_embed) + c["vocab"] * c["hidden"]
    want = 6 * n_matmul * 16 * c["seq"] + 6 * 16 * c["seq"] ** 2 * c[
        "hidden"]
    assert gpt_flops_per_step(c["vocab"], c["hidden"], 1, c["seq"], 16,
                              c["ffn"]) == want


def test_gpt_loss_trajectory_matches_the_jax_train_step():
    """Dropout 0, f32, weights carried from ``bench.build_gpt``: five
    losses rtol 2e-5 (f32 sums in other orders, then Adam), parameters
    atol 2e-5, a fifth of one Adam step.  The key projections' biases
    are held apart, as in the BERT test: softmax ignores a shift shared
    by every key, so their gradient is zero but for rounding and Adam
    moves them up to lr a step either way."""
    c = CPU_CFG
    bench = _bench()
    paddle.seed(2024)
    jm = bench.build_gpt(c["vocab"], c["hidden"], c["layers"], c["heads"],
                         c["ffn"], c["seq"], 0.0)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    jo = jopt.AdamW(learning_rate=2e-4, parameters=jm.parameters(),
                    weight_decay=0.01, grad_clip=JaxClip(1.0))

    def jloss(out, labels):
        w = paddle.transpose(jm.tok.weight, [1, 0])
        bias = paddle.zeros([c["vocab"]], dtype=w.dtype)
        return JF.linear_cross_entropy(out.reshape([-1, c["hidden"]]), w,
                                       bias, labels.reshape([-1]))

    jstep = JaxTrainStep(jm, jloss, jo, n_inputs=1, donate=True)
    tm = build_gpt(c["vocab"], c["hidden"], c["layers"], c["heads"],
                   c["ffn"], c["seq"], 0.0, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(state, "cpu", model=tm))
    tstep = _torch_step(tm, c)
    x, y = _batch(c)
    jl = [float(jstep(jnp.asarray(x), jnp.asarray(y))) for _ in range(5)]
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    assert abs(tl[0] - np.log(c["vocab"])) < 0.5 and tl[-1] < tl[0]
    jw = jm.state_dict()
    for k, v in tm.state_dict().items():
        j = np.asarray(jw[k].numpy())
        if k.endswith(".k.bias"):
            assert np.abs(v.numpy() - state[k]).max() <= 5 * 2e-4 * 1.01
            assert np.abs(j - state[k]).max() <= 5 * 2e-4 * 1.01
            continue
        np.testing.assert_allclose(v.numpy(), j, rtol=0, atol=2e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def dropout_runs():
    """Dropout 0.1, the CPU config: 3 steps with per-block recompute and
    3 without, from one seed and one set of weights; then each run's
    next draws and a fourth step's loss."""
    c = CPU_CFG
    rng.seed(3)
    base = build_gpt(c["vocab"], c["hidden"], c["layers"], c["heads"],
                     c["ffn"], c["seq"], 0.1, device="cpu")
    x, y = (torch.from_numpy(a) for a in _batch(c))
    runs = {}
    for recompute in (True, False):
        model = copy.deepcopy(base)
        model.recompute = recompute
        rng.seed(5)
        step = _torch_step(model, c)
        losses = [float(step(x, y)) for _ in range(3)]
        params = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
        draws = ([rng.next_seed() for _ in range(3)],
                 torch.randint(0, 2 ** 16, (8,),
                               generator=rng.generator("cpu")).tolist())
        runs[recompute] = dict(losses=losses, params=params, draws=draws,
                               next_loss=float(step(x, y)))
    return runs


def test_recompute_gives_bitwise_equal_parameters_at_dropout(dropout_runs):
    """Dropout in the flash attention (seeded per call) and in
    ``F.dropout`` (the device generator): the recomputed forward draws
    the first forward's masks, so losses and parameters are equal bit
    for bit after 3 steps."""
    on, off = dropout_runs[True], dropout_runs[False]
    assert on["losses"] == off["losses"]
    assert len(set(on["losses"])) == 3
    for k, v in on["params"].items():
        assert torch.equal(v, off["params"][k]), k


def test_stream_after_a_recomputed_step_is_the_plain_one(dropout_runs):
    """The next step's masks are equal too: the host seeds and device
    draws that follow, and the fourth step's loss."""
    on, off = dropout_runs[True], dropout_runs[False]
    assert on["draws"] == off["draws"]
    assert on["next_loss"] == off["next_loss"]
