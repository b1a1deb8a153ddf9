"""Eager autograd (the counterpart of ``paddle_tpu.core.autograd``).

torch's autograd is the tape: every op on a tensor that requires a
gradient records its node, and a graph lives as long as a tensor that
reaches it.  This module keeps paddle's contract on top of it:

- ``backward`` of a tensor that is not a scalar needs ``grad_tensor``
  (RuntimeError otherwise, before anything runs); a tensor outside any
  graph (``stop_gradient``) backpropagates nothing; a second backward
  through a freed graph raises RuntimeError (``retain_graph=True``
  keeps it);
- ``grad`` computes gradients without touching ``.grad`` (dense, a
  sparse embedding gradient too); an input the
  outputs do not reach raises RuntimeError unless ``allow_unused``,
  which gives None; ``grad_outputs`` default to ones;
- ``no_grad`` and ``enable_grad`` are context managers and decorators;
- :func:`replaying` says whether a recomputed segment's forward is
  running again in the backward (``parallel.recompute``): a layer whose
  forward mutates state, as BatchNorm's running statistics, leaves it
  as the first forward left it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

from .tensor import wrap

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "replaying", "replay"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad

# per thread: a CUDA backward, and the replay in it, runs on the autograd
# engine's device thread
_tls = threading.local()


def replaying() -> bool:
    return getattr(_tls, "replaying", False)


@contextlib.contextmanager
def replay():
    """The block is a recomputed forward (see :func:`replaying`)."""
    prev = replaying()
    _tls.replaying = True
    try:
        yield
    finally:
        _tls.replaying = prev


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def backward(tensor, grad=None, retain_graph: bool = False):
    """Reverse sweep from ``tensor``; leaves accumulate into ``.grad``."""
    if grad is None and tensor.numel() != 1:
        raise RuntimeError(
            "grad must be provided for non-scalar tensor.backward()")
    if not tensor.requires_grad:
        return
    if grad is not None and not isinstance(grad, torch.Tensor):
        grad = torch.as_tensor(grad, dtype=tensor.dtype,
                               device=tensor.device)
    torch.autograd.backward(tensor, grad, retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: gradients of ``outputs`` with respect to
    ``inputs``, as paddle Tensors; ``.grad`` is left as it is."""
    outs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    gouts = (list(grad_outputs) if isinstance(grad_outputs, (list, tuple))
             else [grad_outputs] * len(outs))
    if retain_graph is None:
        retain_graph = create_graph
    gouts = [torch.ones_like(o) if g is None else g
             for o, g in zip(outs, gouts)]
    live = [i for i, t in enumerate(ins) if t.requires_grad]
    keep = [i for i, o in enumerate(outs) if o.requires_grad]
    results: List[Optional[torch.Tensor]] = [None] * len(ins)
    if live and keep:
        got = torch.autograd.grad(
            [outs[i] for i in keep], [ins[i] for i in live],
            [gouts[i] for i in keep], retain_graph=bool(retain_graph),
            create_graph=bool(create_graph), allow_unused=True)
        for i, g in zip(live, got):
            # a sparse embedding gradient comes out dense, as paddle_tpu
            # gives it
            results[i] = g.to_dense() if g is not None and g.is_sparse \
                else g
    skip = {id(t) for t in (no_grad_vars or [])}
    results = [None if id(t) in skip else r for t, r in zip(ins, results)]
    if not allow_unused:
        for i, r in enumerate(results):
            if r is None:
                raise RuntimeError(
                    f"Input {i} is unreachable from outputs; pass "
                    f"allow_unused=True to get None instead.")
    results = [None if r is None else wrap(r) for r in results]
    return results if isinstance(inputs, (list, tuple)) else results[0]
