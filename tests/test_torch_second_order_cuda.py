"""Fault C9 on the card: a second derivative (``create_graph=True``)
through a hand kernel's autograd Function raises, since the CUDA kernels
compute first derivatives only; the first-order gradient still runs the
kernels.  Needs a CUDA device (``pytest -m cuda``); imports no JAX."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_epilogue as fe
from paddle_tpu_torch.ops.cuda import support


def _qkv(seed, B=2, L=6, H=2, D=64):
    r = np.random.RandomState(seed)
    return [torch.from_numpy(r.randn(B, L, H, D).astype(np.float32)).cuda()
            for _ in range(4)]


@pytest.mark.cuda
def test_cuda_second_derivative_through_a_hand_kernel_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, w = _qkv(6)
    tq = q.clone().requires_grad_()
    out = fa.flash_attention(tq, k, v)
    with pytest.raises(NotImplementedError, match="no second derivative"):
        torch.autograd.grad((out * w).sum(), tq, create_graph=True)
    x = torch.randn(8, 64, device="cuda", requires_grad=True)
    wt = torch.randn(64, 128, device="cuda")
    y = fe.fused_linear_epilogue(x, wt, stages=(("gelu", True),))
    with pytest.raises(NotImplementedError, match="no second derivative"):
        torch.autograd.grad(y.sum(), x, create_graph=True)
    # first order on the card is the kernels', as before
    support.reset_launch_counts()
    g, = torch.autograd.grad((fa.flash_attention(tq, k, v) * w).sum(), tq)
    assert torch.isfinite(g).all()
    assert support.launch_counts.get("flash_attention_bwd_dq") == 1
