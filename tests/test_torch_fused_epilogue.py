"""paddle_tpu_torch's fused matmul epilogue held to paddle_tpu's.

- The seven recipes of paddle_tpu's oracle test: the port's plain
  forward and backward (``fused_linear_epilogue`` on CPU tensors)
  against the Pallas kernel in interpret mode and its ``jax.grad``, on
  the same seeded numpy inputs; tolerance 1e-5 relative to
  max(1, max |ref|) (f32 sums in another order).
- bf16, and the gate against paddle_tpu's on its cases.
- ``cuda``-marked: the CUDA kernels (K2f, K2b) against the plain
  versions on the card; the f32 forward's layer_norm over clusters of
  1-12 blocks, and its zero-bias product bit for bit against K6's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_epilogue as jfe
from paddle_tpu_torch.ops import cuda as torch_cuda
from paddle_tpu_torch.ops import fused_epilogue as fe
from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi

RECIPES = [
    (),
    (("gelu", False),),
    (("gelu", True),),
    (("relu",),),
    (("add",),),
    (("add",), ("layer_norm", 1e-5, True, True)),
    (("layer_norm", 1e-5, True, True),),
]


def _ids(stages):
    return "+".join(x[0] for x in stages) or "bias_only"


def _case(stages, seed=0, M=(2, 16), K=16, N=128):
    """paddle_tpu's ``_epilogue_case``: x, w, b and the stages'
    operands as f32 numpy."""
    r = np.random.RandomState(seed)
    x = r.randn(*M, K).astype(np.float32)
    w = (r.randn(K, N) * 0.3).astype(np.float32)
    b = (r.randn(N) * 0.1).astype(np.float32)
    ops = []
    for st in stages:
        if st[0] == "add":
            ops.append(r.randn(*M, N).astype(np.float32))
        elif st[0] == "layer_norm":
            if st[2]:
                ops.append((1.0 + 0.1 * r.randn(N)).astype(np.float32))
            if st[3]:
                ops.append((0.1 * r.randn(N)).astype(np.float32))
    return x, w, b, ops


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _jax_ref(stages, x, w, b, ops, dtype=jnp.float32):
    arrs = [jnp.asarray(a, dtype) for a in (x, w, b, *ops)]

    def loss(x, w, b, *ops):
        o = jfe.fused_linear_epilogue(x, w, b, stages, ops, interpret=True)
        return jnp.sum(o.astype(jnp.float32) ** 2), o

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(arrs))), has_aux=True)(*arrs)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in grads]


def _port(stages, x, w, b, ops, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in
          (x, w, b, *ops)]
    out = fe.fused_linear_epilogue(ts[0], ts[1], ts[2], stages, ts[3:])
    grads = torch.autograd.grad((out.float() ** 2).sum(), ts)
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


@pytest.mark.parametrize("stages", RECIPES, ids=_ids)
def test_plain_forward_and_backward_match_the_pallas_kernel(stages):
    x, w, b, ops = _case(stages)
    jout, jgrads = _jax_ref(stages, x, w, b, ops)
    tout, tgrads = _port(stages, x, w, b, ops)
    assert tout.shape == jout.shape
    assert _rel(tout, jout) <= 1e-5
    assert len(tgrads) == len(jgrads)
    for name, a, r in zip(["x", "w", "b"] + [f"op{i}" for i in
                                             range(len(ops))],
                          tgrads, jgrads):
        assert a.shape == r.shape, name
        assert _rel(a, r) <= 1e-5, (name, _rel(a, r))


@pytest.mark.parametrize("stages", RECIPES, ids=_ids)
def test_plain_versions_match_the_unfused_composite(stages):
    """The plain kernel math against PyTorch's own ops (the composite the
    kernel replaces), forward and gradients; 1e-5 relative."""
    x, w, b, ops = _case(stages, seed=1)
    tout, tgrads = _port(stages, x, w, b, ops)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b, *ops)]
    ref = fe.reference_epilogue(ts[0], ts[1], ts[2], stages, ts[3:])
    rgrads = torch.autograd.grad((ref ** 2).sum(), ts)
    assert _rel(tout, ref.detach().numpy()) <= 1e-5
    for a, r in zip(tgrads, rgrads):
        assert _rel(a, r.numpy()) <= 1e-5


def test_bf16_matches_the_pallas_kernel():
    """bf16 in, f32 accumulator and epilogue, bf16 out, on both sides:
    they agree to a bf16 rounding (2e-2 of max(1, |ref|)), forward and
    gradients."""
    stages = (("gelu", True),)
    r = np.random.RandomState(1)
    x = r.randn(16, 16).astype(np.float32)
    w = (r.randn(16, 128) * 0.3).astype(np.float32)
    b = (r.randn(128) * 0.1).astype(np.float32)
    jout, jgrads = _jax_ref(stages, x, w, b, [], jnp.bfloat16)
    tout, tgrads = _port(stages, x, w, b, [], torch.bfloat16)
    assert _rel(tout, jout) <= 2e-2
    for a, g in zip(tgrads, jgrads):
        assert _rel(a, g) <= 2e-2


GATE_CASES = [
    ((32, 16), (16, 128), "float32", (), ()),
    ((32, 16), (16, 100), "float32", (), ()),
    ((33, 16), (16, 128), "float32", (), ()),
    ((32, 16), (16, 128), "int32", (), ()),
    ((32, 8), (16, 128), "float32", (), ()),
    ((32, 16), (16, 128), "float32", (("add",),), ((32, 128),)),
    ((32, 16), (16, 128), "float32", (("add",),), ((16, 128),)),
    ((4, 8, 16), (16, 256), "bfloat16",
     (("bias",), ("add",), ("layer_norm", 1e-5, True, True)),
     ((256,), (4, 8, 256), (256,), (1, 256))),
    ((32, 16), (16, 128), "float32", (("layer_norm", 1e-5, True, False),),
     ((128,), (128,))),
]


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_agrees_with_paddle_tpu(case):
    x_shape, w_shape, dtype, stages, op_shapes = case
    want = jfe.fused_epilogue_supported(x_shape, w_shape,
                                        getattr(jnp, dtype), stages,
                                        op_shapes)
    assert fe.fused_epilogue_supported(x_shape, w_shape, dtype, stages,
                                       op_shapes) == want


def test_gate_differences_are_the_cards():
    """paddle_tpu caps the weight at 4 MB (its VMEM); the card does not,
    so BERT-base's fc1 and fc2 chains fuse here.  The card takes at most
    one layer_norm, over at most MAX_LN_N columns."""
    fc1 = ((8192, 768), (768, 3072), (("bias",), ("gelu", True)),
           ((3072,),))
    assert not jfe.fused_epilogue_supported(fc1[0], fc1[1], jnp.float32,
                                            *fc1[2:])
    assert fe.fused_epilogue_supported(fc1[0], fc1[1], torch.float32,
                                       *fc1[2:])
    ln = ("layer_norm", 1e-5, False, False)
    n = cuda_epi.MAX_LN_N
    assert fe.fused_epilogue_supported((64, 8), (8, n), torch.float32,
                                       (ln,))
    assert not fe.fused_epilogue_supported((64, 8), (8, n + 128),
                                           torch.float32, (ln,))
    assert not fe.fused_epilogue_supported((64, 8), (8, 128), torch.float32,
                                           (ln, ln))
    assert jfe.fused_epilogue_supported((64, 8), (8, n + 128), jnp.float32,
                                        (ln,))


def test_stage_label_is_paddle_tpus():
    for stages in RECIPES:
        full = (("bias",),) + stages
        assert fe.stage_label(full) == jfe.stage_label(full)


# ------------------------------------------------------- the CUDA tier
def test_cpu_tensors_take_the_plain_version():
    x, w, b, ops = _case(RECIPES[5])
    before = dict(torch_cuda.support.launch_counts)
    _port(RECIPES[5], x, w, b, ops)
    assert torch_cuda.support.launch_counts == before


def test_kernel_wrappers_refuse_cpu_tensors():
    x, w = torch.zeros(8, 16), torch.zeros(16, 128)
    ops = [torch.zeros(1, 128)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_epi.fused_epilogue_fwd(x, w, ops, (("bias",),))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_epi.fused_epilogue_bwd(x, w, ops, (("bias",),),
                                    torch.zeros(8, 128))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("stages", RECIPES, ids=_ids)
def test_cuda_kernels_match_the_plain_versions(stages, dtype, tol):
    """K2f and K2b through the autograd Function on the card vs the plain
    versions on the same inputs: f32 summed in another order; bf16 g
    and outputs rounded to bf16 on both sides.  Ragged rows (200) and
    depth (72) exercise the kernels' masks; two backward runs agree bit
    for bit."""
    _cuda()
    x, w, b, ops = _case(stages, seed=3, M=(8, 25), K=72, N=256)
    dev = [torch.from_numpy(a).cuda().to(dtype).requires_grad_()
           for a in (x, w, b, *ops)]
    cpu = [t.detach().cpu().requires_grad_() for t in dev]
    outs, grads = [], []
    for ts in (dev, cpu, dev):
        out = fe.fused_linear_epilogue(ts[0], ts[1], ts[2], stages, ts[3:])
        outs.append(out.detach().float().cpu())
        grads.append([g.float().cpu() for g in torch.autograd.grad(
            (out.float() ** 2).sum(), ts)])
    torch.cuda.synchronize()
    assert _rel(outs[0].numpy(), outs[1].numpy()) <= tol
    for a, r in zip(grads[0], grads[1]):
        assert _rel(a.numpy(), r.numpy()) <= tol
    for a, r in zip(grads[0], grads[2]):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", range(1, 13))
def test_cuda_forward_joins_layer_norm_rows_over_a_cluster(blocks):
    """The f32 forward of an add + layer_norm recipe at N = 128 x blocks:
    a cluster of 1-12 blocks joins each row's statistics.  Ragged rows
    (200) and a depth off the 128 tile (72); f32 sums in another order,
    as above."""
    _cuda()
    stages = RECIPES[5]
    x, w, b, ops = _case(stages, seed=5, M=(8, 25), K=72, N=128 * blocks)
    dev = [torch.from_numpy(a).cuda() for a in (x, w, b, *ops)]
    before = torch_cuda.support.launch_counts.get("fused_epilogue_fwd", 0)
    got = fe.fused_linear_epilogue(dev[0], dev[1], dev[2], stages, dev[3:])
    ref = fe.fused_linear_epilogue(*(t.cpu() for t in dev[:3]), stages,
                                   [t.cpu() for t in dev[3:]])
    torch.cuda.synchronize()
    assert _rel(got.cpu().numpy(), ref.numpy()) <= 2e-5
    assert torch_cuda.support.launch_counts["fused_epilogue_fwd"] == \
        before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(200, 72, 256), (8, 8, 128),
                                   (1000, 264, 640)])
def test_cuda_forward_sums_as_k6_does(m, k, n):
    """The f32 forward with a zero bias equals K6's f32 product bit for
    bit: one FMA chain over k in order for every element."""
    _cuda()
    from paddle_tpu_torch.ops.cuda import chunk_matmul as k6
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(m, k, device="cuda", generator=g)
    w = torch.randn(k, n, device="cuda", generator=g)
    k32 = -(-k // 32) * 32     # K6 takes K % 32: zeros add +0 to the chain
    xp = torch.zeros(m, k32, device="cuda")
    wp = torch.zeros(k32, n, device="cuda")
    xp[:, :k], wp[:k] = x, w
    out = cuda_epi.fused_epilogue_fwd(x, w, [torch.zeros(1, n,
                                                         device="cuda")],
                                      (("bias",),))
    ref = k6.chunk_matmul(xp, wp)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    _cuda()
    x, w = torch.zeros(8, 16, device="cuda"), torch.zeros(16, 100,
                                                         device="cuda")
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_epi.fused_epilogue_fwd(x, w, [], ())
    w = torch.zeros(16, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        cuda_epi.fused_epilogue_fwd(x, w, [], ())
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_epi.fused_epilogue_fwd(x[:, :12], w[:12].float(), [], ())
    with pytest.raises(ValueError, match="aligned"):
        cuda_epi.fused_epilogue_fwd(torch.zeros(8 * 16 + 1, device="cuda")[
            1:].view(8, 16), w.float(), [], ())


# ----------------------------------- the f32 backward's layout (CPU)
@pytest.mark.parametrize("m,want", [(8192, (4, 2048)), (1000, (1, 1000)),
                                    (4095, (1, 4096)), (4096, (2, 2048)),
                                    (5000, (2, 2504)), (16384, (8, 2048)),
                                    (1, (1, 8)), (100000, (8, 12504))])
def test_dw_slices_cover_the_rows_once(m, want):
    """dw's split over M: 1, 2, 4 or 8 slices of about 2048 rows, a
    multiple of 8 each; together they cover the M rows, and no slice but
    the last is short."""
    slices, rows = cuda_epi.dw_slices(m)
    assert (slices, rows) == want
    assert slices in (1, 2, 4, 8) and rows % 8 == 0
    assert slices * rows >= m > (slices - 1) * rows


@pytest.mark.parametrize("m", [1, 127, 128, 129, 8192])
def test_partial_rows_follow_the_kernels_row_blocks(m):
    """One row of partial sums per 128-row block at f32 (the register
    tile), two per 32-row block at bf16."""
    assert cuda_epi.partial_rows(m, torch.float32) == -(-m // 128)
    assert cuda_epi.partial_rows(m, torch.bfloat16) == -(-m // 32) * 2


@pytest.mark.cuda
def test_cuda_backward_replays_the_forwards_relu_mask():
    """bias + relu at f32: the first backward launch replays K2f's
    accumulator bit for bit, so its g is dy where K2f's output is
    positive and 0 elsewhere, exactly."""
    _cuda()
    stages = (("bias",), ("relu",))
    x, w, b, _ = _case((), seed=7, M=(1, 1000), K=264, N=640)
    dy = np.random.RandomState(8).randn(1000, 640).astype(np.float32)
    x, w, b, dy = (torch.from_numpy(a).cuda() for a in (x[0], w, b, dy))
    ops = [b.view(1, -1)]
    out = cuda_epi.fused_epilogue_fwd(x, w, ops, stages)
    g, _, _ = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, stages, dy)
    torch.cuda.synchronize()
    assert torch.equal(g, torch.where(out > 0, dy, torch.zeros_like(dy)))


@pytest.mark.cuda
def test_cuda_dw_is_the_slices_summed_in_order():
    """At f32 dw = x^T . g is split over dw_slices(M) slices of rows; the
    kernel's dw equals, bit for bit, the slices' products (each a
    launch of its own) added in slice order, and two runs agree."""
    _cuda()
    m, k, n = 5000, 264, 256
    r = np.random.RandomState(9)
    x, g = (torch.from_numpy(r.randn(*s).astype(np.float32)).cuda()
            for s in ((m, k), (m, n)))
    w = torch.from_numpy(r.randn(k, n).astype(np.float32)).cuda()
    slices, rows = cuda_epi.dw_slices(m)
    assert slices == 2

    def grads(xs, gs):
        part = torch.zeros(cuda_epi.partial_rows(xs.shape[0], torch.float32),
                           1, n, device="cuda")
        return cuda_epi.fused_epilogue_bwd_grads(xs, w, [], gs, part)

    _, dw, _ = grads(x, g)
    _, dw2, _ = grads(x, g)
    want = torch.zeros(k, n, device="cuda")
    for s in range(slices):
        lo, hi = s * rows, min(m, (s + 1) * rows)
        want = want + grads(x[lo:hi].contiguous(), g[lo:hi].contiguous())[1]
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2)
    assert torch.equal(dw, want)
    assert _rel(dw.cpu().numpy(), (x.t() @ g).cpu().numpy()) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [5, 9, 12])
def test_cuda_backward_joins_layer_norm_rows_over_a_cluster(blocks):
    """The f32 backward of an add + layer_norm recipe at N = 128 x blocks:
    the first launch joins each row's statistics and layer_norm's row
    means over a cluster of 5, 9 or 12 blocks.  Gradients of every input
    against the plain version (ragged rows and depth, as above), and two
    runs bit for bit."""
    _cuda()
    stages = RECIPES[5]
    x, w, b, ops = _case(stages, seed=6, M=(8, 25), K=72, N=128 * blocks)
    dev = [torch.from_numpy(a).cuda().requires_grad_()
           for a in (x, w, b, *ops)]
    cpu = [t.detach().cpu().requires_grad_() for t in dev]
    grads = []
    for ts in (dev, cpu, dev):
        out = fe.fused_linear_epilogue(ts[0], ts[1], ts[2], stages, ts[3:])
        grads.append([gr.cpu() for gr in torch.autograd.grad(
            (out ** 2).sum(), ts)])
    torch.cuda.synchronize()
    for a, r in zip(grads[0], grads[1]):
        assert _rel(a.numpy(), r.numpy()) <= 2e-5
    for a, r in zip(grads[0], grads[2]):
        assert torch.equal(a, r)
