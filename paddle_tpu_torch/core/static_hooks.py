"""The replay scope shared by ``core.dispatch`` and the static package
(the counterpart of ``paddle_tpu.core.static_hooks``).

A control-flow node of a static Program (``ops.control_flow``) re-runs
the user's branch and body closures when it executes.  Those closures
name static ``Variable``s and ``Parameter``s; while a replay scope is
active, :func:`~.dispatch.apply` hands each one to the scope's
``lookup`` (its tensor in this run) instead of recording a node.  It
lives in core so that the op hot path checks it with one call, without
importing the static package.

It also holds the ``to_static`` scope: while a ``jit.to_static``
function runs, the paddle Tensor's ``__bool__`` raises (a Python
``if``/``while`` on a tensor that dy2static left unconverted), as
paddle_tpu's traced Tensor does."""
from __future__ import annotations

import threading
from typing import Callable, Optional

__all__ = ["replay_scope", "current_replay", "to_static_scope",
           "in_to_static"]

_tls = threading.local()


class replay_scope:
    """While active, Variables and Parameters reaching ``apply``
    resolve through ``lookup``."""

    def __init__(self, lookup: Callable):
        self._lookup = lookup

    def __enter__(self):
        self._prev = getattr(_tls, "replay", None)
        _tls.replay = self._lookup
        return self

    def __exit__(self, *exc):
        _tls.replay = self._prev
        return False


def current_replay() -> Optional[Callable]:
    return getattr(_tls, "replay", None)


class to_static_scope:
    """While active, the truth value of a paddle Tensor raises."""

    def __enter__(self):
        _tls.to_static = getattr(_tls, "to_static", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.to_static -= 1
        return False


def in_to_static() -> bool:
    return getattr(_tls, "to_static", 0) > 0
