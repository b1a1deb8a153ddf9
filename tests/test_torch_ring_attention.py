"""paddle_tpu_torch's flash block entry and ring attention held to
paddle_tpu's.

- ``flash_attention_block`` (its plain version, the CPU path) and its
  gradients with a nonzero lse cotangent, against the JAX package's
  ``flash_attention_block`` (Pallas, interpret mode) differentiated by
  ``jax.vjp``, at the ring's four offset cases: the causal diagonal
  block, a fully visible block (an earlier shard), a fully masked block
  (a later shard) and a non-causal block (JAX: K at offset -1e9; the
  port: ``causal=False``).  f32; forward atol 2e-6, gradients rtol 1e-4
  / atol 1e-5 (as ``test_torch_flash_attention.py``).
- :func:`merge_blocks` on fully masked rows: weight 0, gradient 0.
- Ring attention at sp of one (the flash block itself).  Its multi-rank
  cases run in ``test_torch_distributed.py``, inside the one spawn of
  gloo ranks that all multi-rank tests share.
- On the card (``-m cuda``): the block entry at the four cases with
  ``dlse``, f32 and bf16; and, with two cards or more, a 2-rank NCCL ring
  attention and collective matmul.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention_block as jax_block
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.cuda import support
from paddle_tpu_torch.parallel.ring_attention import (merge_blocks,
                                                     reference_attention,
                                                     ring_attention)
from paddle_tpu_torch.testing import parallel_cases

# (q_off, k_off, causal) of the port for a 32-row block; JAX's k_off
# for the non-causal block is -1e9 with its always-causal kernel
BLOCKS = {"diagonal": (32, 32, True), "visible": (64, 0, True),
          "masked": (0, 32, True), "noncausal": (32, 64, False)}


def _rand(seed, *shapes):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in shapes]


def _bhld(a):
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_entry_and_dlse_match_the_pallas_block(case):
    q_off, k_off, causal = BLOCKS[case]
    B, L, H, D = 1, 32, 2, 32
    q, k, v, do = _rand(7, *[(B, L, H, D)] * 4)
    dlse = _rand(8, (B, H, L))[0]
    scale = 1 / math.sqrt(D)
    jk_off = k_off if causal else -1e9

    def jfn(q, k, v):
        return jax_block(q, k, v, jnp.full((1, 1), q_off, jnp.float32),
                         jnp.full((1, 1), jk_off, jnp.float32), scale, 32,
                         32)

    (jout, jlse), vjp = jax.vjp(jfn, *(jnp.asarray(_bhld(a))
                                       for a in (q, k, v)))
    jg = vjp((jnp.asarray(_bhld(do)), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = fa.flash_attention_block(tq, tk, tv, q_off, k_off, scale,
                                        causal)
    np.testing.assert_allclose(_bhld(out.detach().numpy()), np.asarray(jout),
                               atol=2e-6, rtol=0)
    if case == "masked":
        # every row sees no key: out 0 and lse -1e30, the kernels' value
        assert (lse == fa.NEG_INF).all() and (out == 0).all()
        assert (np.asarray(jlse) <= -1e29).all()
    else:
        np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                                   atol=2e-6, rtol=1e-6)
    tg = torch.autograd.grad((out, lse), (tq, tk, tv),
                             (torch.from_numpy(do), torch.from_numpy(dlse)))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_bhld(a.numpy()), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    if case == "masked":
        assert all((g == 0).all() for g in tg)


@pytest.mark.parametrize("case", ["diagonal", "visible"])
def test_block_entry_at_head_dim_96_matches_the_pallas_block(case):
    """The block entry and its gradients with dlse at head dim 96 (the
    GPT 760m preset's) against the Pallas block in interpret mode."""
    q_off, k_off, causal = BLOCKS[case]
    B, L, H, D = 1, 32, 2, 96
    q, k, v, do = _rand(10, *[(B, L, H, D)] * 4)
    dlse = _rand(11, (B, H, L))[0]
    scale = 1 / math.sqrt(D)

    def jfn(q, k, v):
        return jax_block(q, k, v, jnp.full((1, 1), q_off, jnp.float32),
                         jnp.full((1, 1), k_off, jnp.float32), scale, 32,
                         32)

    (jout, jlse), vjp = jax.vjp(jfn, *(jnp.asarray(_bhld(a))
                                       for a in (q, k, v)))
    jg = vjp((jnp.asarray(_bhld(do)), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = fa.flash_attention_block(tq, tk, tv, q_off, k_off, scale,
                                        causal)
    np.testing.assert_allclose(_bhld(out.detach().numpy()), np.asarray(jout),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               atol=2e-6, rtol=1e-6)
    tg = torch.autograd.grad((out, lse), (tq, tk, tv),
                             (torch.from_numpy(do), torch.from_numpy(dlse)))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_bhld(a.numpy()), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_block_entry_without_an_lse_cotangent_is_flash_attention():
    q, k, v, w = (torch.from_numpy(a)
                  for a in _rand(9, *[(2, 40, 2, 32)] * 4))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    out, _ = fa.flash_attention_block(*a, causal=True)
    ref = fa.flash_attention(*b, causal=True)
    assert torch.equal(out, ref)
    for x, y in zip(torch.autograd.grad((out * w).sum(), a),
                    torch.autograd.grad((ref * w).sum(), b)):
        assert torch.equal(x, y)


def test_merge_gives_masked_rows_zero_weight_and_zero_gradient():
    """A row of the running result that has seen no key (lse -1e30)
    merged with a block that has: the block's values exactly, and no
    gradient into the masked side; two masked sides stay masked."""
    r = np.random.RandomState(3)
    o_b = torch.from_numpy(r.randn(1, 4, 2, 8).astype(np.float32))
    lse_b = torch.from_numpy(r.randn(1, 2, 4).astype(np.float32))
    o = torch.zeros(1, 4, 2, 8, requires_grad=True)
    lse = torch.full((1, 2, 4), fa.NEG_INF, requires_grad=True)
    mo, ml = merge_blocks(o, lse, o_b, lse_b)
    assert torch.equal(mo, o_b) and torch.equal(ml, lse_b)
    go, gl = torch.autograd.grad((mo.sum() + ml.sum()), (o, lse))
    assert (go == 0).all() and (gl == 0).all()
    mo, ml = merge_blocks(o, lse, torch.zeros_like(o_b),
                          torch.full_like(lse_b, fa.NEG_INF))
    assert (mo == 0).all() and (ml == fa.NEG_INF).all()


def test_single_rank_ring_is_one_block_launch_of_flash():
    """sp of one (no process group): ring attention is the flash block
    itself, at offsets 0."""
    q, k, v = (torch.from_numpy(a) for a in _rand(4, *[(2, 64, 2, 32)] * 3))
    got = ring_attention(q, k, v, is_causal=True)
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=True))
    np.testing.assert_allclose(got.numpy(), reference_attention(
        q, k, v).numpy(), atol=2e-6, rtol=0)


# ------------------------------------------------------- on the card
B, L, H = 2, 32, 2                     # the two-card test's ring inputs


def _cuda(n=1):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, the machine has "
                    f"{torch.cuda.device_count()}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_cuda_block_entry_matches_the_plain_version(dtype, tol, case):
    """The flash kernels through the block entry, forward and backward
    with a nonzero dlse, against the plain version on the same inputs
    (max |a - b| / max(1, max |b|)); one launch of each kernel."""
    _cuda()
    q_off, k_off, causal = BLOCKS[case]
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(2, 32, 3, 128, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    dlse = torch.randn(2, 3, 32, device="cuda", generator=g)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(support.launch_counts)
    out, lse = fa.flash_attention_block(*a, q_off, k_off, None, causal)
    grads = torch.autograd.grad((out, lse), a, (do, dlse))
    ro, rlse = fa.flash_attention_reference_fwd(
        *(t.transpose(1, 2) for t in (q, k, v)), causal=causal, q_off=q_off,
        k_off=k_off)
    refs = fa.flash_attention_reference_bwd(
        *(t.transpose(1, 2) for t in (q, k, v)), ro, rlse,
        do.transpose(1, 2), dlse, causal=causal, q_off=q_off, k_off=k_off)
    torch.cuda.synchronize()
    pairs = [(out.transpose(1, 2), ro), (lse, rlse)] + [
        (x.transpose(1, 2), y) for x, y in zip(grads, refs)]
    for got, ref in pairs:
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max() / ref.abs().max().clamp_min(1)
        assert err.item() <= tol, (case, err.item())
    if case == "masked":
        assert (lse == fa.NEG_INF).all() and (out == 0).all()
        assert all((x == 0).all() for x in grads)
    for kern in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert support.launch_counts.get(kern, 0) == before.get(kern, 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_block_entry_at_every_head_dim(dtype, tol):
    """The block entry at the diagonal and visible cases with dlse, at
    every built head dim, against the plain version."""
    _cuda()
    from paddle_tpu_torch.ops.cuda.flash_attention import SUPPORTED_HEAD_DIMS
    g = torch.Generator(device="cuda").manual_seed(6)
    for D in SUPPORTED_HEAD_DIMS:
        for case in ("diagonal", "visible"):
            q_off, k_off, causal = BLOCKS[case]
            q, k, v, do = (torch.randn(2, 96, 3, D, device="cuda",
                                       generator=g).to(dtype)
                           for _ in range(4))
            dlse = torch.randn(2, 3, 96, device="cuda", generator=g)
            a = [t.clone().requires_grad_() for t in (q, k, v)]
            out, lse = fa.flash_attention_block(*a, q_off, k_off, None,
                                                causal)
            grads = torch.autograd.grad((out, lse), a, (do, dlse))
            t = [x.transpose(1, 2) for x in (q, k, v)]
            ro, rlse = fa.flash_attention_reference_fwd(
                *t, causal=causal, q_off=q_off, k_off=k_off)
            refs = fa.flash_attention_reference_bwd(
                *t, ro, rlse, do.transpose(1, 2), dlse, causal=causal,
                q_off=q_off, k_off=k_off)
            torch.cuda.synchronize()
            pairs = [(out.transpose(1, 2), ro), (lse, rlse)] + [
                (x.transpose(1, 2), y) for x, y in zip(grads, refs)]
            for got, ref in pairs:
                got, ref = got.float(), ref.float()
                err = (got - ref).abs().max() / ref.abs().max().clamp_min(1)
                assert err.item() <= tol, (D, case, err.item())


@pytest.mark.cuda
def test_two_card_nccl_ring_attention_and_collective_matmul(tmp_path):
    """Two NCCL ranks, one card each: ring attention (sp 2) and the
    collective matmuls (mp 2) against the same single-process results."""
    _cuda(2)
    from paddle_tpu_torch.distributed.launch import free_port
    r = np.random.RandomState(1)
    data = {}
    for d in (32, 8):
        for a in "qkvw":
            data[f"{a}_d{d}"] = r.randn(B, L, H, d).astype(np.float32)
    for tag, (m, k, nn) in {"f32": (16, 512, 512), "bf16": (16, 512, 512),
                            "ungated": (16, 256, 128)}.items():
        data[f"x_{tag}"] = r.randn(m, k).astype(np.float32)
        data[f"w_{tag}"] = r.randn(k, nn).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **data)
    spawn(parallel_cases.run, (str(tmp_path), ["two_card"], "cuda"),
          nprocs=2, init_method=f"tcp://localhost:{free_port()}",
          timeout=300)
    for rank in range(2):
        rr = dict(np.load(tmp_path / f"rank{rank}.npz"))
        for d in (32, 8):
            for causal in ("causal", "full"):
                ref = fa.mha_reference(*(torch.from_numpy(data[f"{a}_d{d}"])
                                         for a in "qkv"),
                                       causal=causal == "causal").numpy()
                np.testing.assert_allclose(
                    rr[f"two_card/out_n2_d{d}_{causal}"], ref, rtol=2e-3,
                    atol=2e-4)
        x, w = data["x_f32"], data["w_f32"]
        np.testing.assert_allclose(rr["two_card/col_ring_n2_f32"],
                                   x.astype(np.float64) @ w, rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(rr["two_card/col_ring_n2_f32"],
                                      rr["two_card/col_oracle_n2_f32"])
