"""paddle_tpu_torch's chunk matmul (K6) and fused collective matmuls held
to paddle_tpu's.

- The plain K6 (the CPU path of ``chunk_matmul``) against the JAX
  package's ``chunk_matmul`` in interpret mode and ``jnp.matmul``, and
  the gate against the JAX gate on ``tests/test_pallas.py``'s shapes.
- The fused collective matmuls at axis size 1 (one chunk product).
  Their multi-rank cases run in ``test_torch_distributed.py``, inside
  the one spawn of gloo ranks that all multi-rank tests share.
- K6 on the card (``-m cuda``): ragged M and K at the gate's edges, a
  row-strided x written into a column block of a wider out, f32 and
  bf16, and its column blocks bitwise equal to K6 on the whole weight.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import collective_matmul as jpallas
from paddle_tpu_torch.ops import chunk_matmul as cm
from paddle_tpu_torch.ops.cuda import support

TOL = dict(rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------- plain K6
@pytest.mark.parametrize("m,k,nc", [(16, 128, 128), (256, 256, 128),
                                    (8, 384, 256)])
def test_plain_chunk_matmul_matches_the_pallas_kernel(m, k, nc):
    r = np.random.RandomState(4)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = r.standard_normal((k, nc)).astype(np.float32)
    got = cm.chunk_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    want = np.asarray(jpallas.chunk_matmul(jnp.asarray(x), jnp.asarray(w),
                                           interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jnp.asarray(x) @ jnp.asarray(w)), **TOL)


def test_plain_chunk_matmul_bf16_sums_in_f32():
    """bf16 operands: f32 sums, one rounding to bf16 at the end, as the
    Pallas kernel (the two agree to one bf16 rounding)."""
    r = np.random.RandomState(5)
    x = r.standard_normal((16, 128)).astype(np.float32)
    w = r.standard_normal((128, 128)).astype(np.float32)
    got = cm.chunk_matmul(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    want = jpallas.chunk_matmul(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(w, jnp.bfloat16), interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-2)
    # mixed operands promote to f32
    mixed = cm.chunk_matmul(torch.from_numpy(x),
                            torch.from_numpy(w).bfloat16())
    assert mixed.dtype == torch.float32


def test_gate_is_the_jax_gate():
    f32, bf = (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)
    cases = [((16, 128), (128, 128), f32, f32),
             ((15, 128), (128, 128), f32, f32),
             ((16, 100), (100, 128), f32, f32),
             ((16, 128), (128, 100), f32, f32),
             ((16, 128), (128, 128), (torch.int32, jnp.int32), f32),
             ((2, 16, 128), (128, 128), f32, f32),
             ((16, 128), (64, 128), f32, f32),
             ((8192, 1792), (1792, 7168), bf, bf),
             ((8, 7168), (7168, 1792), bf, f32)]
    for xs, ws, (tx, jx), (tw, jw) in cases:
        assert cm.chunk_matmul_supported(xs, ws, tx, tw) == \
            jpallas.chunk_matmul_supported(xs, ws, jx, jw), (xs, ws)


def test_cpu_tensors_take_the_plain_version():
    before = dict(support.launch_counts)
    x, w = torch.randn(16, 128), torch.randn(128, 256)
    out = torch.zeros(16, 512)
    cm.chunk_matmul(x, w, out[:, 256:])
    assert torch.equal(out[:, 256:], x @ w) and not out[:, :256].any()
    assert support.launch_counts == before
    with pytest.raises(ValueError, match="CUDA"):
        from paddle_tpu_torch.ops.cuda import chunk_matmul as kernel
        kernel.chunk_matmul(x, w)


def test_single_rank_forms_are_one_chunk_product():
    """Axis size 1: both forms are the chunk matmul itself (one K6
    launch on the card, the plain version here)."""
    from paddle_tpu_torch.ops import collective_matmul as tcm
    x, w = torch.randn(16, 128), torch.randn(128, 256)
    for ring in (True, False):
        assert torch.equal(tcm.all_gather_matmul(x, w, "mp", 1, ring=ring),
                           cm.chunk_matmul(x, w))
        assert torch.equal(tcm.matmul_reduce_scatter(x, w, "mp", 1,
                                                     ring=ring),
                           cm.chunk_matmul(x, w))
    assert tcm.lowering_label() == "kernel"


# ------------------------------------------------------- on the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (1000, 384, 640),
                                   (264, 1792, 896), (1000, 96, 640),
                                   (8, 32, 256)])
def test_cuda_kernel_matches_the_plain_version(dtype, tol, m, k, n):
    """K6 at the gate's edges (M 8, the smallest; M not a multiple of the
    128-row tile; K 96 and 32, not multiples of the 64-deep bf16 tile),
    against the plain version, as max |a - b| / max(1,
    max |b|): f32 summed in another order, bf16 rounded once either
    side.  Its column blocks are bitwise equal to K6 on the whole
    weight, written in place into a wider output."""
    _cuda()
    from paddle_tpu_torch.ops.cuda import chunk_matmul as kernel
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
    w = torch.randn(k, n, device="cuda", generator=g).to(dtype)
    before = support.launch_counts.get("chunk_matmul", 0)
    got = kernel.chunk_matmul(x, w)
    ref = cm.chunk_matmul_reference(x, w)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max(
    ).clamp_min(1)
    assert err.item() <= tol, err.item()
    out = torch.full((m, 2 * n), float("nan"), device="cuda", dtype=dtype)
    for j in range(n // 128):
        kernel.chunk_matmul(x, w[:, j * 128:(j + 1) * 128].contiguous(),
                            out[:, n + j * 128:n + (j + 1) * 128])
    torch.cuda.synchronize()
    assert torch.equal(out[:, n:], got)
    assert torch.isnan(out[:, :n].float()).all()
    assert support.launch_counts["chunk_matmul"] == before + 1 + n // 128


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_kernel_reads_strided_x_and_writes_a_column_block(dtype, tol):
    """x a row-strided view (ldx 384 > K 96, the row-parallel form's
    slice) and out a column block of a wider output (ldo 1280 > N 640):
    the product lands in its block and nothing else is written."""
    _cuda()
    from paddle_tpu_torch.ops.cuda import chunk_matmul as kernel
    g = torch.Generator(device="cuda").manual_seed(4)
    wide = torch.randn(1000, 384, device="cuda", generator=g).to(dtype)
    w = torch.randn(96, 640, device="cuda", generator=g).to(dtype)
    x = wide[:, 64:160]
    out = torch.full((1000, 1280), float("nan"), device="cuda", dtype=dtype)
    kernel.chunk_matmul(x, w, out[:, 640:])
    ref = cm.chunk_matmul_reference(x, w)
    torch.cuda.synchronize()
    err = (out[:, 640:].float() - ref.float()).abs().max() / ref.float(
    ).abs().max().clamp_min(1)
    assert err.item() <= tol, err.item()
    assert torch.isnan(out[:, :640].float()).all()


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    _cuda()
    from paddle_tpu_torch.ops.cuda import chunk_matmul as kernel
    x = torch.randn(16, 128, device="cuda")
    with pytest.raises(ValueError, match="multiple"):
        kernel.chunk_matmul(x, torch.randn(128, 100, device="cuda"))
    with pytest.raises(ValueError, match="dtype"):
        kernel.chunk_matmul(x.half(), torch.randn(128, 128, device="cuda"))
    with pytest.raises(ValueError, match="stride"):
        kernel.chunk_matmul(x, torch.randn(128, 128, device="cuda").t())
