"""Crash flight recorder: a readable black box for every bad exit (the
counterpart of ``paddle_tpu/observability/flight.py``).

When installed (:func:`install_flight_recorder`), these triggers dump
the last N tracer events plus a full metrics snapshot and the compile
attribution summary, atomically (through a temporary file and a
rename, so a crash mid-dump never leaves a truncated file):

- an :class:`~..core.enforce.EnforceError` being *constructed* (the
  typed-error taxonomy framework-detected failures pass through),
- an exception escaping ``static.Executor.run`` (both route through the
  ``core.obs_hook`` crash handler; the same exception object is dumped
  once),
- ``SIGTERM`` and any exception reaching ``sys.excepthook``.

Both hooks chain to what they find: the SIGTERM handler installed
before (the ``serve`` CLI's drain, pytest's own) runs after the dump,
and the previous excepthook after the recorder's; uninstalling puts
both back.  The dump is one JSON document: reason, exception (type,
message, traceback), the tracer's newest events (empty when tracing is
off), ``monitor`` stats and histograms, the per-cause compile summary,
and the SLO and perf reports when those are installed.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
import weakref
from typing import Optional

from ..core import flags, obs_hook
from ..utils import monitor

__all__ = ["install_flight_recorder", "uninstall_flight_recorder",
           "dump_flight", "flight_recorder_path"]

_lock = threading.Lock()
_state: Optional[dict] = None


def flight_recorder_path() -> Optional[str]:
    """The installed recorder's dump path, or None."""
    st = _state
    return st["path"] if st is not None else None


def _dump_exc_info(exc: BaseException) -> dict:
    return {
        "type": type(exc).__name__,
        "message": str(exc),
        "traceback": traceback.format_exception(
            type(exc), exc, exc.__traceback__),
    }


def dump_flight(path: Optional[str] = None, reason: str = "manual",
                exc: Optional[BaseException] = None,
                extra: Optional[dict] = None) -> Optional[str]:
    """Write one flight dump now; returns the path (None if a dump was
    already in progress on this thread — reentrancy guard for failures
    inside the dump itself).  ``extra`` lands verbatim under the
    payload's ``"extra"`` key — a supervisor annotates its
    kill-time dumps with the restart reason, attempt and last observed
    step this way."""
    st = _state
    if path is None:
        if st is None:
            raise ValueError("no flight recorder installed; pass path=")
        path = st["path"]
    guard = st["dumping"] if st is not None else _local_guard
    if getattr(guard, "active", False):
        return None
    guard.active = True
    try:
        trc = obs_hook._tracer
        tail = st["events"] if st is not None else 512
        events = ([trc.jsonable(e) for e in trc.events(tail=tail)]
                  if trc is not None else [])
        if trc is not None:
            trc.emit("crash", reason,
                     args={"exc": type(exc).__name__ if exc else None})
        from .compiles import explain_compiles
        from .metrics import build_info
        comp = explain_compiles()
        payload = {
            "reason": reason,
            "time": time.time(),
            "pid": os.getpid(),
            "build": build_info(),
            "exception": _dump_exc_info(exc) if exc is not None else None,
            "events": events,
            # drop accounting rides every dump: a black box whose ring
            # wrapped must say so, or the truncated tape misleads
            "obs": trc.ring_stats() if trc is not None else None,
            "stats": monitor.all_stats(),
            "histograms": monitor.all_histograms(),
            "compiles": {"total": comp["total"],
                         "unexplained": comp["unexplained"],
                         "by_cause": comp["by_cause"]},
        }
        if extra is not None:
            payload["extra"] = extra
        from . import slo as _slo
        if _slo.get_slo_monitor() is not None:
            # last evaluation, not a fresh poll — a dump mid-crash must
            # not start measuring windows
            payload["slo"] = _slo.slo_status(poll=False)
        perf = obs_hook._perf
        if perf is not None:
            payload["perf"] = perf.report()
        from ..utils.checkpoint import write_atomic
        write_atomic(path, json.dumps(payload, default=str).encode())
        monitor.stat_add("flight.dumps")
        return path
    finally:
        guard.active = False


_local_guard = threading.local()


def _on_crash(exc: BaseException, context: str) -> None:
    """core.obs_hook crash handler.

    Dedup is per exception OBJECT via a weakref (a raw id() would let a
    later, distinct exception reuse the freed address and be silently
    skipped) — except that a re-report of the same object that NOW
    carries a traceback upgrades the dump: EnforceError fires at
    construction (``__traceback__`` still None), and the informative
    report is the one from the raise boundary (Executor.run /
    excepthook) with the stack attached."""
    st = _state
    if st is None:
        return
    has_tb = exc.__traceback__ is not None
    prev = st["last_exc"]
    if prev is not None:
        ref, prev_had_tb = prev
        if ref() is exc and (prev_had_tb or not has_tb):
            return
    try:
        st["last_exc"] = (weakref.ref(exc), has_tb)
    except TypeError:       # exotic exception type without weakref slots
        st["last_exc"] = None
    try:
        dump_flight(reason=context, exc=exc)
    except Exception:       # the recorder must never mask the crash
        pass


def _excepthook(exc_type, exc, tb):
    st = _state
    if st is not None:
        if exc is not None and exc.__traceback__ is None:
            exc = exc.with_traceback(tb)
        _on_crash(exc, "unhandled_exception")
        prev = st["prev_excepthook"]
    else:
        prev = sys.__excepthook__
    prev(exc_type, exc, tb)


def _chain_sigterm(on_term):
    """Install a SIGTERM handler that calls ``on_term()`` then the
    handler it replaced.  Returns a ``restore()`` callable, or None
    when that is not possible (off the main thread, or a handler
    installed by non-Python code, which could be neither chained nor
    restored)."""
    if threading.current_thread() is not threading.main_thread():
        return None
    prev = signal.getsignal(signal.SIGTERM)
    if prev is None:
        return None

    def _handler(signum, frame):
        on_term()
        if callable(prev) and prev not in (signal.SIG_IGN,
                                           signal.SIG_DFL):
            prev(signum, frame)

    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        return None

    def restore():
        try:
            signal.signal(signal.SIGTERM, prev)
        except (ValueError, TypeError):
            pass

    return restore


def install_flight_recorder(path: Optional[str] = None, events: int = 512,
                            catch_sigterm: bool = True,
                            catch_excepthook: bool = True) -> str:
    """Arm the flight recorder; returns the dump path.

    ``path`` defaults to ``FLAGS_flight_recorder_path`` (or
    ``./flight_record.json``).  ``events`` bounds how many tracer
    events each dump carries.  SIGTERM hooking chains to the previous
    handler (the ``serve`` CLI's drain keeps working) and is skipped
    off the main thread."""
    global _state
    with _lock:
        if _state is not None:
            _uninstall_locked()
        path = (path or flags.get_flag("flight_recorder_path")
                or "flight_record.json")
        st = {
            "path": path,
            "events": int(events),
            "last_exc": None,
            "dumping": threading.local(),
            "prev_excepthook": None,
            "restore_sigterm": None,
        }
        _state = st
        obs_hook.set_crash_handler(_on_crash)
        if catch_excepthook:
            st["prev_excepthook"] = sys.excepthook
            sys.excepthook = _excepthook
        if catch_sigterm:
            st["restore_sigterm"] = _chain_sigterm(
                lambda: dump_flight(reason="SIGTERM"))
        return path


def _uninstall_locked() -> None:
    global _state
    st = _state
    if st is None:
        return
    _state = None
    if obs_hook.crash_handler() is _on_crash:
        obs_hook.set_crash_handler(None)
    if st["prev_excepthook"] is not None and sys.excepthook is _excepthook:
        sys.excepthook = st["prev_excepthook"]
    if st["restore_sigterm"] is not None:
        st["restore_sigterm"]()


def uninstall_flight_recorder() -> None:
    with _lock:
        _uninstall_locked()
