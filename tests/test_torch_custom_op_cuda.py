"""The custom-op path on the card: a ``register_custom_op`` function
calling the flash-attention entry launches the hand-written kernels
forward and backward on CUDA tensors, a pair-registered op runs its
backward there, and a ``cpp_extension`` op (CPU handlers only) refuses a
CUDA tensor with an error naming it.  Needs a CUDA device and ``g++``
(``pytest -m cuda``); imports no JAX."""
import os
import shutil

import pytest
import torch

import paddle_tpu_torch as T

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "paddle_tpu_torch", "testing", "csrc", "leaky_relu_ext.cpp")


@pytest.mark.cuda
def test_custom_ops_on_cuda_tensors(tmp_path):
    if not torch.cuda.is_available() or shutil.which("g++") is None:
        pytest.skip("needs a CUDA device and g++")
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.ops.flash_attention import (flash_attention,
                                                      mha_reference)
    from paddle_tpu_torch.utils.cpp_extension import load
    attn = T.utils.register_custom_op(
        "user_flash_attention",
        lambda q, k, v: flash_attention(q, k, v, causal=False))
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 128, 4, 64, device="cuda", generator=g,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    support.reset_launch_counts()
    out = attn(q, k, v)
    out.float().sum().backward()
    counts = dict(support.launch_counts)
    assert counts.get("flash_attention_fwd") == 1
    assert counts.get("flash_attention_bwd_dq") == 1
    assert counts.get("flash_attention_bwd_dkv") == 1
    ref = mha_reference(q.detach(), k.detach(), v.detach())
    assert (out.detach().float() - ref.float()).abs().max().item() < 2e-2
    sq = T.utils.register_custom_op(
        "cuda_sq", lambda a: a * a,
        backward=lambda res, ct: (2 * res[0] * ct,))
    x = torch.arange(4.0, device="cuda").requires_grad_()
    sq(x).sum().backward()
    assert torch.equal(x.grad, 2 * torch.arange(4.0, device="cuda"))
    ext = load("leaky_ext", [SRC],
               functions={"leaky_fwd": {"symbol": "LeakyReluFwd",
                                        "out": "like:0"}},
               build_directory=str(tmp_path / "build"))
    y = ext.leaky_fwd(torch.tensor([-2.0, 1.0]), alpha=0.1)
    assert torch.allclose(y, torch.tensor([-0.2, 1.0]))
    with pytest.raises(NotImplementedError, match="LeakyReluFwd"):
        ext.leaky_fwd(torch.ones(3, device="cuda"), alpha=0.1)
