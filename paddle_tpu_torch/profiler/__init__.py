"""profiler (``paddle_tpu.profiler``): tracing and host-op profiling.

Reference: paddle/fluid/platform/profiler.h:127 (RecordEvent),
:210-213 (EnableProfiler/DisableProfiler), python/paddle/profiler/
profiler.py (the 2.x Profiler class), tools/timeline.py:131 (chrome
trace export).

How paddle_tpu's pieces map onto torch:

- ``Profiler(trace_dir=...)`` runs a ``torch.profiler`` session (CPU
  activities, and CUDA's when a card is present) and writes its Chrome
  trace into ``trace_dir`` when it stops: the device timeline, where
  paddle_tpu writes a ``jax.profiler`` trace.  ``device_table()`` reads
  the session's per-kernel device times.
- :class:`RecordEvent` spans are ``torch.profiler.record_function``
  ranges (they show on the trace's host track), accumulate host time
  under their name while a Profiler runs, and land on the observability
  tracer (``core.obs_hook``) as nested spans when tracing is on.
- Per-op host times come through ``core.profiler_hook``, which the op
  dispatch (``core.dispatch.apply``) reads: one module-attribute check
  when no Profiler runs.  ``summary()`` prints the top-k tables the
  reference prints on DisableProfiler.
- ``sync_ops`` (or ``FLAGS_profiler_sync_ops``) synchronises the card
  after each op before its time is taken, so each op's span covers its
  device work; the total then no longer reflects pipelined wall-clock.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict
from enum import Enum
from typing import Dict, List, Optional, Tuple

import torch

from ..core import obs_hook, profiler_hook

__all__ = [
    "Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
    "export_chrome_tracing", "load_profiler_result", "start_profiler",
    "stop_profiler", "profiler_guard",
]


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2   # accepted for parity
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class RecordEvent:
    """Named span (reference: platform/profiler.h:127 RecordEvent).

    Context manager or ``begin()``/``end()`` pair.  Opens a
    ``torch.profiler.record_function`` range (shows on the trace's host
    track), accumulates host time under ``name`` when a Profiler is
    active, and lands on the observability tracer as a nested span
    (correct parent attribution) when tracing is enabled.

    Robustness contract: ``end()`` without a prior ``begin()`` is a
    no-op (not a TypeError), ``end()`` is idempotent, and the context
    manager closes the span even when the body raises."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._rf = None
        self._t0 = None
        self._span = None

    def begin(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        trc = obs_hook._tracer
        if trc is not None:
            self._span = trc.begin_span(self.name)
        self._t0 = time.perf_counter()
        return self

    def end(self):
        t0, self._t0 = self._t0, None
        if t0 is None:      # begin() never ran, or end() ran already
            return
        dt = time.perf_counter() - t0
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(None, None, None)
        prof = profiler_hook.current()
        if prof is not None:
            prof._record(self.name, dt, kind="span")
        span, self._span = self._span, None
        if span is not None:
            trc = obs_hook._tracer
            if trc is not None:
                trc.end_span(span)

    __enter__ = begin

    def __exit__(self, *exc):
        self.end()
        return False


class Profiler:
    """reference: python/paddle/profiler/profiler.py Profiler.

    ``start()``/``stop()`` bracket a profiling session; ``step()`` marks
    iteration boundaries (a RecordEvent span per step).  When
    ``trace_dir`` is set (or ``on_trace_ready=export_chrome_tracing(d)``)
    a ``torch.profiler`` session runs with it and its Chrome trace is
    written into the directory at ``stop()``.  ``summary()`` prints the
    host-side span and op tables, and the device kernel table when a
    session ran.

    Timing semantics: CUDA launches are asynchronous, so by default each
    recorded op time covers only the host side (Python, dispatch and the
    launch); the device work is still in flight when the timer stops.
    ``sync_ops=True`` (or ``FLAGS_profiler_sync_ops``) synchronises the
    card after each op first, so each op's time covers its device work
    too; this serialises the host and the card, so the sum becomes
    per-op attribution while the total no longer reflects pipelined
    wall-clock.  For device timelines use ``trace_dir``."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only: bool = False, trace_dir: Optional[str] = None,
                 sync_ops: Optional[bool] = None):
        from ..core.flags import get_flag
        self.targets = targets
        self._sync_ops = (bool(get_flag("profiler_sync_ops"))
                          if sync_ops is None else bool(sync_ops))
        self._on_trace_ready = on_trace_ready
        self._trace_dir = trace_dir or getattr(on_trace_ready, "_dir", None)
        self._timer_only = timer_only
        self._op_stats: Dict[str, List[float]] = defaultdict(
            lambda: [0, 0.0])      # name -> [count, total_s]
        self._span_stats: Dict[str, List[float]] = defaultdict(
            lambda: [0, 0.0])
        self._step_ann = None
        self._step_count = 0
        self._session = None
        self.trace_path: Optional[str] = None

    # -- hook sink ---------------------------------------------------------
    def _record(self, name: str, dt: float, kind: str = "op"):
        table = self._op_stats if kind == "op" else self._span_stats
        ent = table[name]
        ent[0] += 1
        ent[1] += dt

    def _sync(self, out):
        """``sync_ops``: wait for the card before an op's time is taken
        (called by the op dispatch with the op's result)."""
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        if any(isinstance(o, torch.Tensor) and o.is_cuda for o in leaves):
            torch.cuda.synchronize()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        profiler_hook.set_active(self)
        if self._trace_dir and not self._timer_only:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._session = torch.profiler.profile(activities=acts)
            self._session.start()
        return self

    def stop(self):
        if self._step_ann is not None:
            self._step_ann.end()
            self._step_ann = None
        if self._session is not None:
            self._session.stop()
            os.makedirs(self._trace_dir, exist_ok=True)
            self.trace_path = os.path.join(
                self._trace_dir, f"{socket.gethostname()}_{os.getpid()}_"
                f"{time.time_ns()}.pt.trace.json")
            self._session.export_chrome_trace(self.trace_path)
        if profiler_hook.current() is self:  # don't clobber another one
            profiler_hook.set_active(None)
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)
        return self

    def step(self, num_samples: Optional[int] = None):
        if self._step_ann is not None:
            self._step_ann.end()
        self._step_count += 1
        self._step_ann = RecordEvent(
            f"ProfileStep#{self._step_count}").begin()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reporting ---------------------------------------------------------
    def key_averages(self) -> List[Tuple[str, int, float]]:
        """[(op_name, calls, total_ms)] sorted by total host time."""
        rows = [(n, int(c), 1000.0 * t)
                for n, (c, t) in self._op_stats.items()]
        return sorted(rows, key=lambda r: -r[2])

    def device_table(self) -> List[Tuple[str, int, float]]:
        """[(kernel or op name, calls, total device ms)] of the last
        ``torch.profiler`` session, by total device time (empty without
        a session)."""
        if self._session is None:
            return []
        rows = []
        for e in self._session.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((e.key, int(e.count), dev_us / 1000.0))
        return sorted(rows, key=lambda r: -r[2])

    def summary(self, sorted_by="total", op_detail=True, top_k: int = 20,
                thread_sep=False, time_unit="ms") -> str:
        """Top-k tables (the reference's DisableProfiler print,
        platform/profiler.cc PrintProfiler): spans, eager ops' host
        time, and the device kernels when a session ran."""
        lines = []
        if self._span_stats:
            lines.append(f"{'span':<32}{'calls':>8}{'total_ms':>12}"
                         f"{'avg_ms':>10}")
            for n, (c, t) in sorted(self._span_stats.items(),
                                    key=lambda kv: -kv[1][1])[:top_k]:
                lines.append(f"{n:<32}{c:>8}{1000 * t:>12.3f}"
                             f"{1000 * t / max(c, 1):>10.3f}")
            lines.append("")
        lines.append(f"{'op (eager host dispatch)':<32}{'calls':>8}"
                     f"{'total_ms':>12}{'avg_ms':>10}")
        for n, c, tms in self.key_averages()[:top_k]:
            lines.append(f"{n:<32}{c:>8}{tms:>12.3f}"
                         f"{tms / max(c, 1):>10.3f}")
        dev = self.device_table()
        if dev:
            lines.append("")
            lines.append(f"{'device (torch.profiler)':<32}{'calls':>8}"
                         f"{'total_ms':>12}{'avg_ms':>10}")
            for n, c, tms in dev[:top_k]:
                lines.append(f"{n[:31]:<32}{c:>8}{tms:>12.3f}"
                             f"{tms / max(c, 1):>10.3f}")
        out = "\n".join(lines)
        print(out)
        return out


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready factory (reference: profiler.py
    export_chrome_tracing; tools/timeline.py): points the Profiler at a
    directory, where ``stop()`` writes the session's Chrome trace."""
    def handler(prof):
        return None

    handler._dir = dir_name
    return handler


def load_profiler_result(path: str):
    """Parity shim: the Chrome traces are read with Perfetto or
    chrome://tracing."""
    raise NotImplementedError(
        "load the .pt.trace.json file with ui.perfetto.dev or "
        "chrome://tracing (torch.profiler writes Chrome traces)")


# -- fluid-era API (reference: python/paddle/fluid/profiler.py) -------------

_legacy: Optional[Profiler] = None


def start_profiler(state="All", tracer_option="Default"):
    global _legacy
    _legacy = Profiler()
    _legacy.start()


def stop_profiler(sorted_key="total", profile_path=None):
    global _legacy
    if _legacy is not None:
        _legacy.stop()
        text = _legacy.summary(sorted_by=sorted_key)
        if profile_path:
            with open(profile_path, "w") as f:
                f.write(text)
        _legacy = None


@contextlib.contextmanager
def profiler_guard(state="All", sorted_key="total", profile_path=None):
    """fluid.profiler.profiler context (reference: fluid/profiler.py:35)."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
