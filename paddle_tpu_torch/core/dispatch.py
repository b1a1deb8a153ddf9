"""The record-or-run point (``paddle_tpu.core.dispatch.apply`` and the
static hooks it consults).

Every paddle op of the port's ``nn.functional`` (and the static
``Variable``'s operators) goes through :func:`apply`: on tensors it
calls the op's function, and when any input is a static ``Variable`` it
records one node, under the op's paddle name, into that Variable's
Program instead.  Recording happens at the level of paddle ops, not of
torch's: the nodes carry paddle_tpu's op names (``linear``, ``add``,
``gelu``, ``layer_norm``, ...) and their parameters as explicit
``attrs``, which is what the static Executor's fusion matcher reads.

Inside a replay scope (:mod:`.static_hooks`: a static control-flow
node re-running the user's closures) a Variable or a Parameter input is
replaced by its tensor in the running step, and the op runs.

Under ``amp.auto_cast`` the tensor inputs are cast here, by the op's
name, before the op runs (the JAX package's AMP hook sits at the same
point); a recorded node is never cast.

With a tracer installed whose ``trace_ops`` is on
(``observability.enable``), every eager op that runs here lands on it
as one ``op`` event (its host duration), and with a ``profiler.Profiler``
running (``core.profiler_hook``) its host time lands in the Profiler's
op table; disabled, the op path pays one module-attribute None-check
for each.  Ops that never pass through here (a
Tensor method or operator that calls torch directly) emit nothing
(ROADMAP §C).

The eager result comes out as a paddle :class:`~.tensor.Tensor` (the
JAX package wraps at the same point): a plain ``torch.Tensor`` result,
or each one of a tuple or list, is re-typed in place.  An op that fails
carries its paddle name (``[operator < name > error]``), as there.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from torch.nn import Parameter

from ..amp import amp_active, amp_cast_inputs
from . import obs_hook, profiler_hook
from .enforce import with_op_hint
from .static_hooks import current_replay
from .tensor import wrap

__all__ = ["Symbolic", "apply"]


class Symbolic:
    """Base of the static ``Variable``: a symbolic input that makes
    :func:`apply` record instead of run.  Subclasses carry ``program``."""

    __slots__ = ()


def apply(fn: Callable, *inputs, op_name: str,
          attrs: Optional[dict] = None):
    """``fn(*inputs, **attrs)``, or, when an input is a static Variable,
    a node recorded into its Program (returns the output Variable(s))."""
    replay = current_replay()
    if replay is not None:
        inputs = tuple(replay(x) if isinstance(x, (Symbolic, Parameter))
                       else x for x in inputs)
    else:
        for x in inputs:
            if isinstance(x, Symbolic):
                return x.program.record(fn, inputs, op_name, attrs or {})
    if amp_active():
        inputs = amp_cast_inputs(op_name, inputs)
    trc = obs_hook._tracer
    prof = profiler_hook._active
    t0 = (time.perf_counter() if trc is not None or prof is not None
          else 0.0)
    try:
        out = fn(*inputs, **attrs) if attrs else fn(*inputs)
    except Exception as e:
        raise with_op_hint(e, op_name)
    if prof is not None:
        if prof._sync_ops:
            prof._sync(out)
        prof._record(op_name, time.perf_counter() - t0)
    if trc is not None:
        trc.op(op_name, t0, time.perf_counter())
    return wrap(out)
