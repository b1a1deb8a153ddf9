"""``parallel.recompute`` held to plain execution and to paddle_tpu's
``recompute``: gradients through a recomputed segment equal the
unrecomputed ones, with dropout drawn inside the segment (the flash
kernels' seeded mask and ``F.dropout``'s device generator) and under
``amp.auto_cast``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.parallel import recompute as jax_recompute
from paddle_tpu_torch import amp, jit, nn, optimizer, seed
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.parallel import recompute, recompute_sequential
from paddle_tpu_torch.testing.models import build_gpt, gpt_pretrain_loss


class _Block(torch.nn.Module):
    """The JAX test's ``Sequential(Linear(4, 16), Tanh(), Linear(16, 4))``."""

    def __init__(self):
        super().__init__()
        self.l0 = nn.Linear(4, 16, device="cpu")
        self.l1 = nn.Linear(16, 4, device="cpu")

    def forward(self, x):
        return self.l1(torch.tanh(self.l0(x)))


def _jax_grads(state, x):
    """paddle_tpu: grads of sum(recompute(block, x)) w.r.t. x and the
    first weight."""
    paddle.seed(6)
    block = jnn.Sequential(jnn.Linear(4, 16), jnn.Tanh(), jnn.Linear(16, 4))
    block.set_state_dict({"0.weight": state["l0.weight"],
                          "0.bias": state["l0.bias"],
                          "2.weight": state["l1.weight"],
                          "2.bias": state["l1.bias"]})
    xt = paddle.to_tensor(x)
    xt.stop_gradient = False
    jax_recompute(block, xt).sum().backward()
    return np.asarray(xt.grad.numpy()), np.asarray(block[0].weight.grad
                                                   .numpy())


@pytest.mark.parametrize("form", ["layer", "callable"])
def test_recompute_matches_plain(form):
    """The port's counterpart of test_distributed.py's
    test_recompute_matches_plain: x's and the first weight's gradients
    through ``recompute(block, x)`` (or a plain function closing over
    the block) equal the unrecomputed ones bit for bit, and paddle_tpu's
    to rtol 1e-5 (f32 sums in other orders)."""
    seed(6)
    block = _Block()
    x0 = np.random.RandomState(6).randn(8, 4).astype(np.float32)
    fn = block if form == "layer" else (lambda t: block(t) * 1.0)
    grads = []
    for rc in (True, False):
        x = torch.from_numpy(x0).requires_grad_()
        out = recompute(fn, x) if rc else fn(x)
        gx, gw = torch.autograd.grad(out.sum(), [x, block.l0.weight])
        grads.append((gx, gw))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    jx, jw = _jax_grads({k: v.detach().numpy() for k, v in
                         block.state_dict().items()}, x0)
    np.testing.assert_allclose(grads[0][0].numpy(), jx, rtol=1e-5)
    np.testing.assert_allclose(grads[0][1].numpy(), jw, rtol=1e-5)


def test_recompute_sequential_matches_plain():
    seed(7)
    blocks = [_Block(), _Block()]
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(7))
    out = recompute_sequential({}, blocks, x.requires_grad_())
    g_rc = torch.autograd.grad(out.pow(2).sum(), [x] + [
        b.l0.weight for b in blocks])
    g = torch.autograd.grad(blocks[1](blocks[0](x)).pow(2).sum(), [x] + [
        b.l0.weight for b in blocks])
    assert all(torch.equal(a, b) for a, b in zip(g_rc, g))


def _attn_segment(q, k, v):
    """Causal flash attention with dropout 0.1 (its seed from
    ``rng.next_seed``) followed by ``F.dropout`` (the device
    generator)."""
    a = F.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                       is_causal=True)
    return F.dropout(a, 0.1)


def _attn_grads(rc, preserve_rng_state=True, device="cpu"):
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(2, 16, 2, 32, generator=gen).to(device)
               .requires_grad_() for _ in range(3))
    do = torch.randn(2, 16, 2, 32, generator=gen).to(device)
    rng.seed(3)
    out = (recompute(_attn_segment, q, k, v,
                     preserve_rng_state=preserve_rng_state) if rc
           else _attn_segment(q, k, v))
    grads = torch.autograd.grad(out, [q, k, v], do)
    return out.detach(), grads, rng.next_seed()


def test_flash_segment_at_dropout_recomputes_its_masks():
    """A flash segment at dropout 0.1: output, dQ, dK and dV equal the
    unrecomputed ones bit for bit, the masks dropped something, and the
    host stream after it is the plain one's."""
    out_rc, g_rc, next_rc = _attn_grads(True)
    out, g, nxt = _attn_grads(False)
    assert torch.equal(out_rc, out) and next_rc == nxt
    assert all(torch.equal(a, b) for a, b in zip(g_rc, g))
    assert (out == 0).float().mean() > 0.05


def test_flash_segment_without_the_state_replay_differs():
    """The same segment with ``preserve_rng_state=False`` draws other
    masks in its second forward, so its gradients differ: the replay is
    what makes the test above pass."""
    out_free, g_free, _ = _attn_grads(True, preserve_rng_state=False)
    out, g, _ = _attn_grads(False)
    assert torch.equal(out_free, out)
    assert not any(torch.equal(a, b) for a, b in zip(g_free, g))


@pytest.mark.cuda
def test_cuda_flash_segment_recomputes_its_masks():
    """On the card: the recomputed flash forward (a second kernel
    launch) regenerates the first one's in-kernel mask from the replayed
    seed, so output and gradients equal the unrecomputed ones bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.ops.cuda import support
    support.reset_launch_counts()
    out_rc, g_rc, next_rc = _attn_grads(True, device="cuda")
    fwd_rc = support.launch_counts.get("flash_attention_fwd", 0)
    out, g, nxt = _attn_grads(False, device="cuda")
    assert fwd_rc == 2
    assert support.launch_counts["flash_attention_fwd"] == 3
    assert torch.equal(out_rc, out) and next_rc == nxt
    assert all(torch.equal(a, b) for a, b in zip(g_rc, g))


def test_recompute_reenters_auto_cast():
    """Under ``auto_cast`` O1 the segment's linear runs in bf16; its
    second forward, run by the backward outside the block, does too
    (else torch's check of the recomputed tensors' dtypes raises), and
    the gradients equal the unrecomputed ones."""
    seed(9)
    lin = nn.Linear(8, 8, device="cpu")
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(9))
    grads = []
    for rc in (True, False):
        with amp.auto_cast(level="O1"):
            out = recompute(lin, x) if rc else lin(x)
        assert out.dtype == torch.bfloat16
        grads.append(torch.autograd.grad(out.float().sum(), [lin.weight,
                                                             lin.bias]))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_train_step_recompute_nests_with_per_block_recompute():
    """``TrainStep(recompute=True)`` over the GPT whose blocks recompute
    themselves (segments nested), dropout 0.1: parameters after 2 steps
    equal those of the plain step bit for bit."""
    seed(4)
    base = build_gpt(100, 64, 2, 2, 128, 16, 0.1, device="cpu")
    x = torch.randint(0, 100, (2, 16),
                      generator=torch.Generator().manual_seed(4))
    params = []
    for rc in (True, False):
        model = build_gpt(100, 64, 2, 2, 128, 16, 0.1, device="cpu")
        model.load_state_dict(base.state_dict())
        seed(5)
        step = jit.TrainStep(model, gpt_pretrain_loss(model, 100),
                             optimizer.AdamW(learning_rate=1e-3,
                                             parameters=model.parameters()),
                             recompute=rc)
        for _ in range(2):
            step(x, x)
        params.append([p.detach() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*params))
