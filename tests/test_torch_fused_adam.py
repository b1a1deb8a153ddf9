"""paddle_tpu_torch's fused Adam held to paddle_tpu's.

- A 6-step trajectory of the plain version (the CPU path of
  ``fused_adam_update``) against paddle_tpu's Pallas kernel in interpret
  mode, at the two ragged shapes of paddle_tpu's test; within 1e-6.
- Eligibility as paddle_tpu's ``fused_update_for`` has it.
- ``cuda``-marked: the CUDA kernel (K3, one multi-tensor launch)
  against the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_adam import \
    fused_adam_update as jax_fused_adam_update
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.ops import cuda as torch_cuda
from paddle_tpu_torch.ops import fused_adam as fa


@pytest.mark.parametrize("shape", [(7,), (130, 33)])
def test_trajectory_matches_the_pallas_kernel(shape):
    r = np.random.RandomState(0)
    p0 = r.randn(*shape).astype(np.float32)
    jp, jm, jv = (jnp.asarray(p0), jnp.zeros(shape, jnp.float32),
                  jnp.zeros(shape, jnp.float32))
    tp, tm, tv = (torch.from_numpy(p0.copy()), torch.zeros(shape),
                  torch.zeros(shape))
    for step in range(1, 7):
        g = r.randn(*shape).astype(np.float32)
        jp, jm, jv = jax_fused_adam_update(jp, jnp.asarray(g), jm, jv, 1e-3,
                                           float(step), interpret=True)
        tp, tm, tv = fa.fused_adam_update(tp, torch.from_numpy(g), tm, tv,
                                          1e-3, float(step))
    for a, b in ((tp, jp), (tm, jm), (tv, jv)):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-6


def test_update_in_place_matches_the_single_tensor_entry():
    """``FusedAdam`` over a list updates each tensor in place exactly as
    ``fused_adam_update`` does one."""
    r = np.random.RandomState(1)
    shapes = [(5, 3), (4,)]
    ps = [torch.from_numpy(r.randn(*s).astype(np.float32)) for s in shapes]
    gs = [torch.from_numpy(r.randn(*s).astype(np.float32)) for s in shapes]
    ms = [torch.zeros(s) for s in shapes]
    vs = [torch.zeros(s) for s in shapes]
    want = [fa.fused_adam_update(p, g, m, v, 1e-2, 1.0)
            for p, g, m, v in zip(ps, gs, ms, vs)]
    fa.FusedAdam(ps, gs, ms, vs)(torch.tensor(1e-2), torch.tensor(1.0))
    for (wp, wm, wv), p, m, v in zip(want, ps, ms, vs):
        assert torch.equal(wp, p) and torch.equal(wm, m)
        assert torch.equal(wv, v)


def _slots(params):
    return [{"m": torch.zeros_like(p), "v": torch.zeros_like(p)}
            for p in params]


def test_eligibility_is_paddle_tpus():
    p = [torch.zeros(8, 8)]
    g = [torch.zeros(8, 8)]
    assert fa.fused_update_for(optimizer.Adam(1e-3), p, g,
                               _slots(p)) is not None
    # AdamW (decoupled decay), clip, coupled decay, multi-precision and
    # bf16 parameters stay on the composite update
    assert fa.fused_update_for(optimizer.AdamW(1e-3, weight_decay=0.01), p,
                               g, _slots(p)) is None
    assert fa.fused_update_for(optimizer.Adam(
        1e-3, grad_clip=optimizer.ClipGradByGlobalNorm(1.0)), p, g,
        _slots(p)) is None
    assert fa.fused_update_for(optimizer.Adam(1e-3, weight_decay=0.01), p,
                               g, _slots(p)) is None
    assert fa.fused_update_for(optimizer.Adam(1e-3, multi_precision=True),
                               p, g, _slots(p)) is None
    pb = [torch.zeros(8, 8, dtype=torch.bfloat16)]
    assert fa.fused_update_for(optimizer.Adam(1e-3), pb, pb,
                               _slots(pb)) is None


def test_cpu_tensors_take_the_plain_version():
    before = dict(torch_cuda.support.launch_counts)
    fa.fused_adam_update(torch.ones(4), torch.ones(4), torch.zeros(4),
                         torch.zeros(4), 1e-3, 1.0)
    assert torch_cuda.support.launch_counts == before


def test_kernel_table_refuses_cpu_tensors():
    t = [torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA"):
        torch_cuda.AdamTable(t, t, t, t)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_cuda_kernel_matches_the_plain_version():
    """One launch over tensors of ragged sizes (vector and scalar
    paths), 5 steps against the plain version: within 1e-6."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(7,), (130, 33), (4096, 9), (70001,)]
    sides = []
    ps = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    for _ in range(2):
        sides.append(([p.clone() for p in ps],
                      [torch.zeros_like(p) for p in ps],
                      [torch.zeros_like(p) for p in ps],
                      [torch.zeros_like(p) for p in ps]))
    kern = fa.FusedAdam(*sides[0])
    lr = torch.full((), 1e-3, device="cuda")
    step = torch.zeros((), device="cuda")
    before = torch_cuda.support.launch_counts.get("fused_adam", 0)
    for _ in range(5):
        step += 1
        for s, g0, g1 in zip(shapes, sides[0][1], sides[1][1]):
            g0.copy_(torch.randn(s, generator=gen, device="cuda"))
            g1.copy_(g0)
        kern(lr, step)
        fa.fused_adam_reference_(*sides[1], lr, step)
    torch.cuda.synchronize()
    assert torch_cuda.support.launch_counts["fused_adam"] == before + 5
    for a, b in zip(sides[0], sides[1]):
        for x, y in zip(a, b):
            assert (x - y).abs().max().item() < 1e-6
