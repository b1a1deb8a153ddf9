"""User ops (the counterpart of ``paddle_tpu/utils/custom_op.py``;
reference: the C++ custom-operator path,
paddle/fluid/framework/custom_operator.cc).

A custom op is a function on torch tensors.  Registering it routes it
through the op dispatch point (``core.dispatch.apply``), so it gets
what a built-in op gets: torch's autograd tape, the cast of its inputs
under ``amp.auto_cast`` (by its name, before the function sees them),
a profiler and tracer ``op`` event under its name, and static capture:
inside a ``Program`` it records one node, which ``Executor.run`` runs
(the recording infers its outputs on meta tensors, so the function
must run on them, as torch's own ops and a ``cpp_extension`` op with
its ``out`` spec do).

Without ``backward`` autograd differentiates ``forward``.  With one,
``backward(res, grad_out) -> tuple(grads)``, ``res`` the tuple of the
forward's inputs and one gradient (or None) an input, the op is a
``torch.autograd.Function`` (paddle_tpu's ``jax.custom_vjp`` pair).

On the card a custom op's function calls the port's hand-written
kernels (``ops.flash_attention``, ``ops.cuda``), where paddle_tpu's
would call a Pallas kernel; C++ host kernels come from
:func:`~.cpp_extension.load`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.dispatch import apply

__all__ = ["register_custom_op", "get_custom_op"]

_registry = {}


class _CustomBackward(torch.autograd.Function):
    """``forward(*inputs, **attrs)`` with the user's backward."""

    @staticmethod
    def forward(ctx, forward, backward, attrs, *inputs):
        out = forward(*inputs, **attrs)
        ctx.backward = backward
        ctx.tensor_at = [i for i, x in enumerate(inputs)
                         if isinstance(x, torch.Tensor)]
        ctx.inputs = [None if isinstance(x, torch.Tensor) else x
                      for x in inputs]
        ctx.save_for_backward(*[inputs[i] for i in ctx.tensor_at])
        ctx.multi = isinstance(out, (tuple, list))
        return tuple(out) if ctx.multi else out

    @staticmethod
    def backward(ctx, *grad_outputs):
        res = list(ctx.inputs)
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            res[i] = t
        grads = tuple(ctx.backward(tuple(res), grad_outputs if ctx.multi
                                   else grad_outputs[0]))
        if len(grads) != len(res):
            raise ValueError(f"custom op backward gave {len(grads)} "
                             f"gradients for {len(res)} inputs")
        return (None, None, None) + tuple(
            g if isinstance(x, torch.Tensor) else None
            for g, x in zip(grads, res))


def register_custom_op(name: str, forward: Callable,
                       backward: Optional[Callable] = None) -> Callable:
    """Register ``forward(*tensors, **attrs) -> tensor(s)`` as op
    ``name`` and return the op (tensors in, paddle Tensors out), also
    found by :func:`get_custom_op`.  A second registration of a name
    replaces the first."""
    if backward is not None:
        def core(*inputs, **attrs):
            return _CustomBackward.apply(forward, backward, attrs, *inputs)
    else:
        core = forward

    def op(*tensors, **attrs):
        return apply(core, *tensors, op_name=name, attrs=attrs)

    op.__name__ = name
    _registry[name] = op
    return op


def get_custom_op(name: str) -> Callable:
    return _registry[name]
