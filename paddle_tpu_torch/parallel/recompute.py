"""Activation recompute (``paddle_tpu.parallel.recompute``).

A recomputed segment keeps only its inputs: its forward runs once
without keeping what its backward needs, and again in the backward to
make it (``torch.utils.checkpoint``, non-reentrant, so
``torch.autograd.grad`` reaches through it and segments nest).  The
second forward sees what the first one saw:

- the same parameters (the segment reads the layer's own);
- the same random draws: ``core.rng``'s state (the active stream, its
  host generator, behind the flash kernels' dropout seeds, and its
  device generators, behind ``F.dropout``) is taken before the first
  forward, put back for the second, and the state found then is put
  back after it.  torch's ``preserve_rng_state`` covers only torch's
  default generators, which the port's ops do not draw from;
- the same ``amp.auto_cast`` state, which torch's own autocast save
  does not cover;
- no state update: it runs under ``core.autograd.replay()``, so
  BatchNorm's running statistics move once a step, as under the JAX
  package's ``jax.checkpoint``.

So the recomputed flash attention draws its first run's seed and
dropout mask, and the stream after a step is the stream after the same
step run without recompute.
"""
from __future__ import annotations

import contextlib

from torch.utils.checkpoint import checkpoint

from ..amp import _entered, amp_state
from ..core import autograd, rng

__all__ = ["recompute", "recompute_sequential"]


def _contexts(preserve_rng_state):
    """The (forward, recompute) context pair of one segment."""
    amp = amp_state()
    before = rng.get_rng_state() if preserve_rng_state else None

    @contextlib.contextmanager
    def again():
        now = rng.get_rng_state() if preserve_rng_state else None
        if preserve_rng_state:
            rng.set_rng_state(before)
        try:
            with _entered(amp), autograd.replay():
                yield
        finally:
            if preserve_rng_state:
                rng.set_rng_state(now)

    return contextlib.nullcontext(), again()


def recompute(function, *args, preserve_rng_state=True, **kwargs):
    """``function(*args, **kwargs)`` (a layer or any callable of
    tensors) as a recomputed segment: its activations are made again in
    the backward instead of kept."""
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=lambda: _contexts(preserve_rng_state),
                      **kwargs)


def recompute_sequential(ctx, functions, *args):
    """Each of ``functions`` (layers) in turn as its own segment."""
    out = args
    for f in functions:
        out = recompute(f, *(out if isinstance(out, tuple) else (out,)))
    return out
