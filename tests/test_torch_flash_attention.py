"""paddle_tpu_torch flash attention held to paddle_tpu's.

The port's plain versions (the CPU path of ``flash_attention`` and the
oracle of the CUDA kernels) against the Pallas kernels run in interpret
mode, as ``tests/test_pallas.py`` runs them, and against
``mha_reference``; the gradients of the port's autograd Function
against ``jax.grad`` of the JAX kernel.  Same seeded numpy inputs on
both sides; f32 tolerances 2e-6 for the forward and lse (the same f32
math summed in another order), rtol 1e-4 / atol 1e-5 for gradients (as
test_pallas.py holds the Pallas backward to its oracle).

Dropout mirrors ``tests/test_flash_dropout.py``, which needs a TPU: the
port's mask is a counter-based hash, so here it is tested on the CPU,
bit for bit against a scalar uint32 implementation of the same hash.
The kernels themselves are held to the plain versions on the card
(``-m cuda``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu.ops.pallas import mha_reference as jax_mha
from paddle_tpu.ops.pallas.flash_attention import (_bwd as jax_bwd,
                                                   _fwd as jax_fwd,
                                                   flash_attention_block)
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.ops import cuda as torch_cuda
from paddle_tpu_torch.ops import flash_attention as fa

ATOL = 2e-6
M32 = 0xFFFFFFFF


def _qkv(seed, B=2, Lq=128, Lk=None, H=2, D=32, n=3):
    r = np.random.RandomState(seed)
    Lk = Lq if Lk is None else Lk
    shapes = [(B, Lq, H, D), (B, Lk, H, D), (B, Lk, H, D), (B, Lq, H, D)]
    return [r.randn(*s).astype(np.float32) for s in shapes[:n]]


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _bhld(a):
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_lse_match_the_pallas_kernel(causal):
    q, k, v = _qkv(0)
    scale = 1 / math.sqrt(32)
    zero = jnp.zeros((1, 1), jnp.float32)
    jout, jlse = jax_fwd(*(jnp.asarray(_bhld(a)) for a in (q, k, v)), zero,
                         zero, jnp.zeros((1, 1), jnp.int32), scale, causal,
                         64, 64, True)
    out, lse = fa.flash_attention_reference_fwd(
        *_t(_bhld(q), _bhld(k), _bhld(v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=1e-6)
    # the public [B, L, H, D] entry, and both dense oracles
    got = fa.flash_attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_flash(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, block_q=64,
        block_k=64)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, fa.mha_reference(
        *_t(q, k, v), causal=causal).numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_mha(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal)), atol=ATOL,
        rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_grad_of_the_pallas_kernel(causal):
    q, k, v, w = _qkv(1, B=1, Lq=64, D=16, n=4)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=32, block_k=32)
        return jnp.sum(o * w)

    jg = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                             (tq, tk, tv))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_backward_with_dlse_matches_the_pallas_backward():
    """delta = rowsum(dO * O) - dlse, as ``_bwd`` folds the lse
    cotangent (the ring-attention path)."""
    q, k, v, do = (_bhld(a) for a in _qkv(2, B=1, Lq=64, D=16, n=4))
    dlse = np.random.RandomState(3).randn(1, 2, 64).astype(np.float32)
    scale = 0.25
    out, lse = fa.flash_attention_reference_fwd(*_t(q, k, v), causal=True,
                                                scale=scale)
    zero = jnp.zeros((1, 1), jnp.float32)
    jg = jax_bwd(*(jnp.asarray(a) for a in (q, k, v)), zero, zero,
                 jnp.zeros((1, 1), jnp.int32), jnp.asarray(out.numpy()),
                 jnp.asarray(lse.numpy()), jnp.asarray(do),
                 jnp.asarray(dlse), scale, True, 32, 32, True)
    tg = fa.flash_attention_reference_bwd(*_t(q, k, v), out, lse,
                                          *_t(do, dlse), causal=True,
                                          scale=scale)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("offsets", [(64, 0), (0, 32), (0, 96)],
                         ids=["q-ahead", "k-ahead", "rows-see-nothing"])
def test_causal_offsets_and_cross_lengths_match_the_ring_block(offsets):
    """Global-position masking (``q_off + i >= k_off + j``) with Lq !=
    Lk, against ``flash_attention_block``; rows that see no key give
    out = 0 and lse = -1e30, as the TPU kernel's."""
    q_off, k_off = offsets
    q, k, v = (_bhld(a) for a in _qkv(4, B=1, Lq=64, Lk=32, D=16))
    scale = 0.25
    jout, jlse = flash_attention_block(
        *(jnp.asarray(a) for a in (q, k, v)),
        jnp.full((1, 1), q_off, jnp.float32),
        jnp.full((1, 1), k_off, jnp.float32), scale, 32, 32)
    out, lse = fa.flash_attention_reference_fwd(*_t(q, k, v), causal=True,
                                                scale=scale, q_off=q_off,
                                                k_off=k_off)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=1e-6)
    if k_off - q_off > 0:
        assert (lse[..., :k_off - q_off] == fa.NEG_INF).all()
        assert (out[:, :, :k_off - q_off] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_96_forward_and_gradients_match_the_pallas_kernel(causal):
    """Head dim 96 (the GPT 760m preset's, 1536 / 16): the plain
    versions against the Pallas kernel in interpret mode, forward and
    lse, and the gradients against jax.grad of it; tolerances as
    above."""
    q, k, v, w = _qkv(15, B=1, Lq=64, D=96, n=4)
    scale = 1 / math.sqrt(96)
    zero = jnp.zeros((1, 1), jnp.float32)
    jout, jlse = jax_fwd(*(jnp.asarray(_bhld(a)) for a in (q, k, v)), zero,
                         zero, jnp.zeros((1, 1), jnp.int32), scale, causal,
                         32, 32, True)
    out, lse = fa.flash_attention_reference_fwd(
        *_t(_bhld(q), _bhld(k), _bhld(v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=1e-6)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=32, block_k=32)
        return jnp.sum(o * w)

    jg = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    tg = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                             (tq, tk, tv))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_head_dim_96_causal_offsets_match_the_ring_block():
    """Global-offset masking at head dim 96 with Lq != Lk, rows that see
    no key included, against the JAX block entry."""
    q_off, k_off = 0, 48
    q, k, v = (_bhld(a) for a in _qkv(16, B=1, Lq=64, Lk=32, D=96))
    scale = 1 / math.sqrt(96)
    jout, jlse = flash_attention_block(
        *(jnp.asarray(a) for a in (q, k, v)),
        jnp.full((1, 1), q_off, jnp.float32),
        jnp.full((1, 1), k_off, jnp.float32), scale, 32, 32)
    out, lse = fa.flash_attention_reference_fwd(*_t(q, k, v), causal=True,
                                                scale=scale, q_off=q_off,
                                                k_off=k_off)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    assert (lse[..., :k_off - q_off] == fa.NEG_INF).all()
    np.testing.assert_allclose(lse[..., k_off:].numpy(),
                               np.asarray(jlse)[..., k_off:], atol=ATOL,
                               rtol=1e-6)


def test_supported_is_a_capability_gate():
    shape = (2, 512, 12, 64)
    for dt in (torch.float32, torch.bfloat16):
        assert fa.flash_attention_supported(shape, shape, dt)
        assert fa.flash_attention_supported(shape, shape, dt, None, 0.1)
    assert fa.flash_attention_supported((2, 7, 3, 32), (2, 9, 3, 32),
                                        torch.float32)  # ragged, short
    assert not fa.flash_attention_supported(shape, shape, torch.float16)
    assert not fa.flash_attention_supported(shape, shape, torch.float32,
                                            attn_mask=torch.ones(1))
    for dt in (torch.float32, torch.bfloat16):      # every built head dim
        for d in (32, 64, 96, 128):
            assert fa.flash_attention_supported((2, 512, 16, d),
                                                (2, 512, 16, d), dt)
    assert not fa.flash_attention_supported((2, 512, 12, 48),
                                            (2, 512, 12, 48), torch.float32)
    assert not fa.flash_attention_supported((2, 512, 64), (2, 512, 64),
                                            torch.float32)


# ------------------------------------------------------------- dropout
def _fmix(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _keep_scalar(seed, bh, q, k, t):
    """The CUDA kernels' keep rule, in plain Python uint32."""
    rk = _fmix(_fmix((seed * 0x9E3779B1 ^ bh * 0x85EBCA77) & M32)
               ^ ((q * 0xC2B2AE3D) & M32))
    x = _fmix(rk ^ (((k >> 1) * 0x27D4EB2F) & M32))
    bits = x >> 16 if k & 1 else x & 0xFFFF
    return bits >= t


def test_mask_is_the_kernels_hash_and_does_not_depend_on_tiling():
    p, seed = 0.3, -123456789          # a negative int32 seed
    t, _ = rng.dropout_threshold(p)
    big = fa.dropout_keep_mask(seed, 2, 3, 200, 130, p, "cpu")
    part = fa.dropout_keep_mask(seed, 2, 3, 70, 33, p, "cpu")
    assert torch.equal(big[:, :, :70, :33], part)
    r = np.random.RandomState(5)
    for _ in range(200):
        b, h, q, k = (int(r.randint(n)) for n in (2, 3, 200, 130))
        assert bool(big[b, h, q, k]) == _keep_scalar(
            seed & M32, b * 3 + h, q, k, t)


def test_kept_fraction_and_quantised_scale():
    p = 0.1
    t, scale = rng.dropout_threshold(p)
    assert t == 6554 and scale == 65536.0 / (65536 - 6554)
    keep = fa.dropout_keep_mask(7, 4, 4, 256, 256, p, "cpu")
    want = 1 - t / 65536
    sigma = math.sqrt(want * (1 - want) / keep.numel())
    assert abs(keep.float().mean().item() - want) < 4 * sigma
    other = fa.dropout_keep_mask(8, 4, 4, 256, 256, p, "cpu")
    assert (keep != other).float().mean().item() > 0.1
    assert fa.dropout_keep_mask(7, 1, 1, 8, 8, 0.0, "cpu") is None
    assert not fa.dropout_keep_mask(7, 1, 1, 8, 8, 1.0, "cpu").any()


def test_p0_with_a_seed_is_bit_equal_to_no_dropout():
    q, k, v = _t(*_qkv(6))
    base = fa.flash_attention(q, k, v, causal=True)
    z = fa.flash_attention(q, k, v, causal=True, dropout_p=0.0, seed=1)
    assert torch.equal(z, base)


def test_deterministic_per_seed_and_varies_across_seeds():
    q, k, v = _t(*_qkv(7))
    f = lambda s: fa.flash_attention(q, k, v, causal=True, dropout_p=0.2,
                                     seed=s)
    a, b, c = f(7), f(7), f(8)
    assert torch.equal(a, b)
    assert (a - c).abs().max().item() > 1e-4


def test_expectation_is_unbiased():
    q, k, v = _t(*_qkv(8, D=64))
    base = fa.flash_attention(q, k, v, causal=True)
    S = 96
    acc = sum(fa.flash_attention(q, k, v, causal=True, dropout_p=0.3,
                                 seed=100 + i) for i in range(S))
    rel = ((acc / S - base).abs().mean() / base.abs().mean()).item()
    assert rel < 0.12, rel            # ~1/sqrt(S) sampling noise


def test_p1_drops_everything():
    q, k, v = _t(*_qkv(9))
    out = fa.flash_attention(q, k, v, causal=True, dropout_p=1.0, seed=1)
    assert out.abs().max().item() == 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_backward_matches_autograd_through_a_naive_attention(causal):
    """The recompute-from-lse backward with the regenerated mask equals
    autograd through dense attention that applies the same mask to the
    normalised weights (denominator undropped)."""
    p, seed, D = 0.25, 42, 32
    q, k, v, w = _qkv(10, Lq=96, n=4)
    keep = fa.dropout_keep_mask(seed, 2, 2, 96, 96, p, "cpu")
    _, scale = rng.dropout_threshold(p)

    def naive(q, k, v):
        s = torch.einsum("blhd,bshd->bhls", q, k) / math.sqrt(D)
        if causal:
            s = s.masked_fill(~torch.ones(96, 96, dtype=torch.bool).tril(),
                              fa.NEG_INF)
        wts = torch.softmax(s, dim=-1) * keep * scale
        return torch.einsum("bhls,bshd->blhd", wts, v)

    ta = _t(q, k, v, grad=True)
    tb = _t(q, k, v, grad=True)
    oa = fa.flash_attention(*ta, causal=causal, dropout_p=p, seed=seed)
    ob = naive(*tb)
    np.testing.assert_allclose(oa.detach().numpy(), ob.detach().numpy(),
                               atol=ATOL, rtol=0)
    wt = torch.from_numpy(w)
    ga = torch.autograd.grad((oa * wt).sum(), ta)
    gb = torch.autograd.grad((ob * wt).sum(), tb)
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------- the CUDA tier
def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, do = _t(*_qkv(11, n=4))
    lse = torch.zeros(2, 2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        torch_cuda.flash_attention_fwd(q, k, v, scale=0.2)
    with pytest.raises(ValueError, match="CUDA"):
        torch_cuda.flash_attention_bwd_dq(q, k, v, do, lse, lse, scale=0.2,
                                          )
    with pytest.raises(ValueError, match="CUDA"):
        torch_cuda.flash_attention_bwd_dkv(q, k, v, do, lse, lse,
                                           scale=0.2)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _t(*_qkv(12), grad=True)
    before = dict(torch_cuda.support.launch_counts)
    out = fa.flash_attention(q, k, v, dropout_p=0.1, seed=3)
    out.sum().backward()
    assert torch_cuda.support.launch_counts == before


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_cuda_kernels_match_the_plain_versions(dtype, tol, causal, p):
    """Forward, lse and the three gradients through the autograd
    Function on the card vs the plain versions on the same inputs and
    seed: f32 summed in another order; bf16 probabilities and dS rounded
    to bf16 before the tensor-core products.  A ragged length (100) and
    each compiled head dim."""
    _cuda()
    for D in torch_cuda.flash_attention.SUPPORTED_HEAD_DIMS:
        q, k, v, do = (torch.from_numpy(a).cuda().to(dtype)
                       for a in _qkv(13, B=2, Lq=100, H=3, D=D, n=4))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = fa.flash_attention(qg, kg, vg, causal=causal, dropout_p=p,
                                 seed=5)
        grads = torch.autograd.grad(out, (qg, kg, vg), do)
        _, lse = torch_cuda.flash_attention_fwd(
            q, k, v, scale=1 / math.sqrt(D), causal=causal, dropout_p=p,
            seed=5)
        b = lambda x: x.transpose(1, 2)                # noqa: E731
        kw = dict(causal=causal, dropout_p=p, seed=5)
        ro, rlse = fa.flash_attention_reference_fwd(b(q), b(k), b(v), **kw)
        refs = fa.flash_attention_reference_bwd(b(q), b(k), b(v), ro, rlse,
                                                b(do), **kw)
        torch.cuda.synchronize()
        for got, ref in [(b(out), ro), (lse, rlse)] + list(
                zip(map(b, grads), refs)):
            got, ref = got.float(), ref.float()
            err = ((got - ref).abs().max() / ref.abs().max().clamp_min(1))
            assert err.item() <= tol, (D, err.item())


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    _cuda()
    q = torch.randn(1, 64, 2, 48, device="cuda")          # D = 48
    with pytest.raises(ValueError, match="head_dim"):
        torch_cuda.flash_attention_fwd(q, q, q, scale=0.1)
    q = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        torch_cuda.flash_attention_fwd(q, q, q, scale=0.1)
    q = torch.randn(1, 2, 64, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        torch_cuda.flash_attention_fwd(q, q, q, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(64, 0), (0, 32), (0, 160)],
                         ids=["q-ahead", "k-ahead", "rows-see-nothing"])
def test_cuda_kernels_take_causal_offsets(offsets):
    """The kernels' global-offset masking (the ring entry's contract),
    Lq != Lk and rows that see no key (out 0, lse -1e30), against the
    plain versions; f32, tolerance as above."""
    _cuda()
    q_off, k_off = offsets
    q, k, v, do = (torch.from_numpy(a).cuda()
                   for a in _qkv(14, B=2, Lq=130, Lk=100, H=2, D=64, n=4))
    kw = dict(scale=0.125, causal=True, dropout_p=0.1, seed=9,
              q_off=q_off, k_off=k_off)
    out, lse = torch_cuda.flash_attention_fwd(q, k, v, **kw)
    delta = fa.attention_delta(do.transpose(1, 2), out.transpose(1, 2))
    dq = torch_cuda.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = torch_cuda.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                **kw)
    b = lambda x: x.transpose(1, 2)                    # noqa: E731
    ro, rlse = fa.flash_attention_reference_fwd(b(q), b(k), b(v), **kw)
    refs = fa.flash_attention_reference_bwd(b(q), b(k), b(v), ro, rlse,
                                            b(do), **kw)
    torch.cuda.synchronize()
    for got, ref in [(b(out), ro), (lse, rlse), (b(dq), refs[0]),
                     (b(dk), refs[1]), (b(dv), refs[2])]:
        err = (got - ref).abs().max() / ref.abs().max().clamp_min(1)
        assert err.item() <= 2e-5, err.item()
    if k_off > q_off:
        assert (lse[..., :k_off - q_off] == fa.NEG_INF).all()
        assert (out[:, :k_off - q_off] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_is_bitwise_deterministic(dtype):
    """No atomics: two backward runs on the same inputs give bitwise
    equal dq, dk and dv, at every built head dim, with dropout."""
    _cuda()
    for D in torch_cuda.flash_attention.SUPPORTED_HEAD_DIMS:
        q, k, v, do = (torch.from_numpy(a).cuda().to(dtype)
                       for a in _qkv(17, B=2, Lq=300, H=3, D=D, n=4))
        kw = dict(scale=1 / math.sqrt(D), causal=True, dropout_p=0.1,
                  seed=11)
        out, lse = torch_cuda.flash_attention_fwd(q, k, v, **kw)
        delta = fa.attention_delta(do.transpose(1, 2), out.transpose(1, 2))
        runs = [(torch_cuda.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   **kw),
                 *torch_cuda.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                     **kw))
                for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b), D


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_ragged_keys_with_causal_offsets(dtype, tol):
    """Lk 200 (not a multiple of any tile) against Lq 130 at causal
    offsets, at every built head dim: the three kernels against the
    plain versions (max |a - b| / max(1, max |b|))."""
    _cuda()
    for D in torch_cuda.flash_attention.SUPPORTED_HEAD_DIMS:
        q, do = (torch.from_numpy(a).cuda().to(dtype)
                 for a in _qkv(18, B=2, Lq=130, H=2, D=D, n=2))
        k, v = (torch.from_numpy(a).cuda().to(dtype)
                for a in _qkv(19, B=2, Lq=200, H=2, D=D, n=2))
        kw = dict(scale=1 / math.sqrt(D), causal=True, dropout_p=0.1,
                  seed=3, q_off=100, k_off=40)
        out, lse = torch_cuda.flash_attention_fwd(q, k, v, **kw)
        delta = fa.attention_delta(do.transpose(1, 2), out.transpose(1, 2))
        dq = torch_cuda.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = torch_cuda.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    **kw)
        b = lambda x: x.transpose(1, 2)                # noqa: E731
        ro, rlse = fa.flash_attention_reference_fwd(b(q), b(k), b(v), **kw)
        refs = fa.flash_attention_reference_bwd(b(q), b(k), b(v), ro, rlse,
                                                b(do), **kw)
        torch.cuda.synchronize()
        for got, ref in [(b(out), ro), (lse, rlse), (b(dq), refs[0]),
                         (b(dk), refs[1]), (b(dv), refs[2])]:
            got, ref = got.float(), ref.float()
            err = (got - ref).abs().max() / ref.abs().max().clamp_min(1)
            assert err.item() <= tol, (D, err.item())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_f32_backward_on_whole_tiles(causal):
    """The f32 dQ and dK/dV kernels (register tiles of 128 or 64 rows)
    at L 256, where every tile is whole and off the diagonal takes the
    unmasked path, with dropout, at every built head dim: against the
    plain version (f32 summed in another order, 2e-5 of max(1, |ref|)),
    and two runs bit for bit."""
    _cuda()
    for D in torch_cuda.flash_attention.SUPPORTED_HEAD_DIMS:
        q, k, v, do = (torch.from_numpy(a).cuda()
                       for a in _qkv(20, B=2, Lq=256, H=2, D=D, n=4))
        kw = dict(scale=1 / math.sqrt(D), causal=causal, dropout_p=0.1,
                  seed=21)
        out, lse = torch_cuda.flash_attention_fwd(q, k, v, **kw)
        delta = fa.attention_delta(do.transpose(1, 2), out.transpose(1, 2))
        runs = [(torch_cuda.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   **kw),
                 *torch_cuda.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                     **kw))
                for _ in range(2)]
        b = lambda x: x.transpose(1, 2)                # noqa: E731
        ro, rlse = fa.flash_attention_reference_fwd(b(q), b(k), b(v), **kw)
        refs = fa.flash_attention_reference_bwd(b(q), b(k), b(v), ro, rlse,
                                                b(do), **kw)
        torch.cuda.synchronize()
        for got, ref in zip(runs[0], refs):
            err = (b(got) - ref).abs().max() / ref.abs().max().clamp_min(1)
            assert err.item() <= 2e-5, (D, err.item())
        for a, c in zip(*runs):
            assert torch.equal(a, c), D


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_f32_forward_is_bitwise_deterministic(causal):
    """The f32 forward (register tiles, one block a query tile, keys in a
    fixed order): two runs give bitwise equal out and lse at every built
    head dim, with dropout."""
    _cuda()
    for D in torch_cuda.flash_attention.SUPPORTED_HEAD_DIMS:
        q, k, v = (torch.from_numpy(a).cuda()
                   for a in _qkv(22, B=2, Lq=300, H=3, D=D))
        kw = dict(scale=1 / math.sqrt(D), causal=causal, dropout_p=0.1,
                  seed=23)
        runs = [torch_cuda.flash_attention_fwd(q, k, v, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b), D


# (Lq, Lk, causal, q_off, k_off): whole tiles, ragged ends, causal at
# offsets either way
_F32_FWD = {"whole_tiles": (256, 256, False, 0, 0),
            "whole_tiles_causal": (256, 256, True, 0, 0),
            "ragged": (130, 200, False, 0, 0),
            "causal_q_ahead": (130, 200, True, 100, 40),
            "causal_k_ahead": (200, 130, True, 0, 70)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_F32_FWD))
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_cuda_f32_forward_matches_the_plain_version(case, p):
    """The f32 forward kernel alone (out and lse) against the plain
    version at every built head dim: f32 summed in another order and the
    probabilities by ex2.approx, 2e-5 of max(1, |ref|); rows that see no
    key give out 0 and lse -1e30."""
    _cuda()
    Lq, Lk, causal, q_off, k_off = _F32_FWD[case]
    for D in torch_cuda.flash_attention.SUPPORTED_HEAD_DIMS:
        q, = (torch.from_numpy(a).cuda()
              for a in _qkv(24, B=2, Lq=Lq, H=2, D=D, n=1))
        k, v = (torch.from_numpy(a).cuda()
                for a in _qkv(25, B=2, Lq=Lk, H=2, D=D, n=2))
        kw = dict(scale=1 / math.sqrt(D), causal=causal, dropout_p=p,
                  seed=26, q_off=q_off, k_off=k_off)
        out, lse = torch_cuda.flash_attention_fwd(q, k, v, **kw)
        b = lambda x: x.transpose(1, 2)                # noqa: E731
        ro, rlse = fa.flash_attention_reference_fwd(b(q), b(k), b(v), **kw)
        torch.cuda.synchronize()
        seen = rlse > fa.NEG_INF / 2           # rows that see a key
        assert torch.equal(lse[~seen], rlse[~seen])
        for got, ref in ((b(out), ro), (lse[seen], rlse[seen])):
            err = (got - ref).abs().max() / ref.abs().max().clamp_min(1)
            assert err.item() <= 2e-5, (D, err.item())
        if causal and k_off > q_off:
            assert (lse[..., :k_off - q_off] == fa.NEG_INF).all()
            assert (out[:, :k_off - q_off] == 0).all()
