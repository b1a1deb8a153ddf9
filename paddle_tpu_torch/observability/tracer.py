"""Structured event tracer: a process-wide ring buffer of typed events
(the counterpart of ``paddle_tpu/observability/tracer.py``).

Spans, eager op dispatches, compiles, checkpoint saves and restores,
serving dispatches, swaps and fault fires land on one correlated
timeline:

- Events are plain dicts in a bounded ``collections.deque`` (appends on
  a deque with ``maxlen`` are atomic under the GIL — no lock on the
  emit path; snapshots copy).  Each event carries a monotonic ``ts``,
  ``kind``, ``name``, the emitting thread id, the current ``step``
  correlation id (set by the static Executor per run) and optional
  ``args`` / ``dur`` / parent-span attribution.
- Spans nest per thread: :meth:`Tracer.begin_span` /
  :meth:`Tracer.end_span` keep a thread-local stack, so a span records
  its parent id; mismatched ends are tolerated (orphans are closed,
  never leaked).
- Export: :meth:`Tracer.chrome_trace` (the trace-event JSON that
  chrome://tracing and Perfetto load: ``ph`` X for durations, i for
  instants, C for counters) and :meth:`Tracer.export_jsonl` (one JSON
  object per event, wall-clock stamped).

Opt-in: ``observability.enable()`` installs one into
``core.obs_hook``; disabled, every instrumented site pays a single
module-attribute None-check.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Tracer", "EVENT_KINDS"]

# Documented event taxonomy (the "typed" in typed events).  ``emit``
# accepts any string so layers can grow new kinds without touching this
# module; exporters only special-case "counter".
EVENT_KINDS = (
    "span",             # named duration (RecordEvent, executor.run, ...)
    "op",               # one eager op dispatch (host-side duration)
    "counter",          # a counter delta next to its monitor stat
    "compile",          # an attributed compile (observability.compiles)
    "worker_restart",   # DataLoader worker respawned in place
    "checkpoint",       # save / restore / fallback / preempt_*
    "serving",          # enqueue / dispatch / shed / deadline_expired
    "fault",            # an injected fault fired (testing.fault)
    "crash",            # flight-recorder dump trigger
    "perf",             # step anatomy lane (observability.perf)
    "slo",              # SLO breach / recover (observability.slo)
    "instant",          # free-form user event
)


class Tracer:
    def __init__(self, capacity: int = 8192, trace_ops: bool = True):
        self.capacity = int(capacity)
        self.trace_ops = bool(trace_ops)
        self._buf: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._step: Optional[int] = None
        self._emitted = 0
        # monotonic<->wall anchor so exports can stamp real times
        self._mono0 = time.perf_counter()
        self._wall0 = time.time()

    # -- correlation -------------------------------------------------------
    def set_step(self, step: int) -> None:
        """Set the current training-step correlation id (the static
        Executor calls this with its per-program run counter)."""
        self._step = int(step)

    @property
    def step(self) -> Optional[int]:
        return self._step

    # -- distributed trace context -----------------------------------------
    def set_trace(self, trace_id: Optional[str],
                  parent_span: Optional[str] = None) -> None:
        """Bind a distributed trace context to this thread: every event
        emitted here until :meth:`clear_trace` carries ``trace`` (and
        ``remote_parent`` when the caller handed us a parent span id
        from another process).  The serving HTTP front-end binds the
        adopted/minted ``X-Trace-Id`` around request handling; the
        engines copy the context onto queued requests so the scheduler
        threads' events inherit it via rid/sid correlation."""
        if trace_id is None:
            self.clear_trace()
            return
        self._tls.trace = (str(trace_id),
                           str(parent_span) if parent_span else None)

    def clear_trace(self) -> None:
        self._tls.trace = None

    def current_trace(self) -> Optional[str]:
        """This thread's bound trace id, or None."""
        ctx = getattr(self._tls, "trace", None)
        return ctx[0] if ctx else None

    # -- emission ----------------------------------------------------------
    def emit(self, kind: str, name: str, args: Optional[dict] = None,
             ts: Optional[float] = None, dur: Optional[float] = None,
             parent: Optional[int] = None, sid: Optional[int] = None
             ) -> int:
        """Append one event; returns its id.  ``ts`` is a
        ``time.perf_counter()`` stamp (defaults to now), ``dur`` is in
        seconds.  ``parent`` defaults to this thread's innermost open
        span, so any event emitted inside a span tree attaches to it
        without the caller threading ids through."""
        ev: Dict[str, object] = {
            "id": next(self._ids) if sid is None else sid,
            "ts": time.perf_counter() if ts is None else ts,
            "kind": kind,
            "name": name,
            "tid": threading.get_ident(),
        }
        if self._step is not None:
            ev["step"] = self._step
        if dur is not None:
            ev["dur"] = dur
        if parent is None:
            stack = getattr(self._tls, "stack", None)
            if stack:
                parent = stack[-1][0]
        if parent is not None:
            ev["parent"] = parent
        ctx = getattr(self._tls, "trace", None)
        if ctx is not None:
            ev["trace"] = ctx[0]
            if ctx[1] is not None and parent is None:
                # cross-process attribution: the root of this process's
                # subtree names the caller's span id
                ev["remote_parent"] = ctx[1]
        if args:
            ev["args"] = args
        self._emitted += 1
        self._buf.append(ev)
        return ev["id"]  # type: ignore[return-value]

    def counter(self, name: str, delta, value=None) -> None:
        """Record a counter delta (the sibling of ``monitor.stat_add``
        at instrumented sites)."""
        args = {"delta": delta}
        if value is not None:
            args["value"] = value
        self.emit("counter", name, args=args)

    def op(self, name: str, t0: float, t1: float) -> None:
        """One eager op dispatch (called from core.dispatch.apply when
        ``trace_ops``)."""
        if self.trace_ops:
            self.emit("op", name, ts=t0, dur=t1 - t0)

    # -- spans -------------------------------------------------------------
    def begin_span(self, name: str, **args) -> int:
        """Open a named span on this thread; returns the span id.  The
        span event is emitted at :meth:`end_span` (with its duration and
        its parent's id)."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        sid = next(self._ids)
        parent = stack[-1][0] if stack else None
        stack.append((sid, name, time.perf_counter(), parent,
                      args or None))
        return sid

    def end_span(self, sid: int) -> None:
        """Close span ``sid``.  Spans left open above it on this
        thread's stack (a ``begin`` whose ``end`` was lost to an
        exception) are closed too, keeping parent attribution sound.
        An id not on this thread's stack (double end, or an end from a
        thread that never began it) is ignored — it must not drain the
        live spans."""
        stack = getattr(self._tls, "stack", None)
        if not stack or not any(s[0] == sid for s in stack):
            return
        now = time.perf_counter()
        while stack:
            s_id, name, t0, parent, args = stack.pop()
            self.emit("span", name, args=args, ts=t0, dur=now - t0,
                      parent=parent, sid=s_id)
            if s_id == sid:
                break

    @contextlib.contextmanager
    def span(self, name: str, **args):
        sid = self.begin_span(name, **args)
        try:
            yield sid
        finally:
            self.end_span(sid)

    # -- snapshots / export ------------------------------------------------
    def events(self, tail: Optional[int] = None) -> List[dict]:
        """Snapshot of buffered events (oldest first); ``tail`` keeps
        only the newest N."""
        evs = list(self._buf)
        if tail is not None and tail < len(evs):
            evs = evs[-tail:]
        return evs

    @property
    def emitted(self) -> int:
        """Total events emitted (>= len(events()) once the ring wraps)."""
        return self._emitted

    @property
    def dropped(self) -> int:
        """Events the full ring evicted under pressure — nonzero means
        the buffered trace is a truncated view of what was emitted.
        Derived from the emit counter (the buffer is append-only, so
        it holds exactly ``min(emitted, capacity)`` events) — per-emit
        boundary bookkeeping raced between threads and could report a
        clean tape for a truncated one."""
        return max(0, self._emitted - self.capacity)

    @property
    def high_watermark(self) -> int:
        """Most events ever buffered at once (== capacity once the
        ring has wrapped); derived like :attr:`dropped`."""
        return min(self._emitted, self.capacity)

    def ring_stats(self) -> dict:
        """Drop accounting block exporters embed next to any trace
        snapshot; also mirrors the ``obs.events_dropped`` stat and the
        capacity/high-watermark gauges into ``monitor``."""
        from ..utils import monitor
        dropped, hwm = self.dropped, self.high_watermark
        monitor.stat_set("obs.events_dropped", dropped)
        monitor.stat_set("obs.ring_capacity", self.capacity)
        monitor.stat_set("obs.ring_high_watermark", hwm)
        return {"events_emitted": self._emitted,
                "events_dropped": dropped,
                "ring_capacity": self.capacity,
                "ring_high_watermark": hwm}

    def wall_time(self, ts: float) -> float:
        """Convert a perf_counter stamp to unix wall-clock seconds."""
        return self._wall0 + (ts - self._mono0)

    def jsonable(self, ev: dict) -> dict:
        """One event as a JSON-ready dict with wall-clock timestamps."""
        out = dict(ev)
        out["time"] = round(self.wall_time(ev["ts"]), 6)
        out["ts"] = round(ev["ts"] - self._mono0, 9)
        if "dur" in out:
            out["dur"] = round(out["dur"], 9)
        return out

    def export_jsonl(self, path: Optional[str] = None) -> str:
        """JSONL dump of the buffer; writes to ``path`` when given,
        returns the text either way."""
        text = "\n".join(json.dumps(self.jsonable(e))
                         for e in self.events())
        if text:
            text += "\n"
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def chrome_trace(self) -> dict:
        """The buffer in chrome trace-event format (load in
        chrome://tracing or ui.perfetto.dev).  Durations map to ``ph:
        "X"`` complete events, counters to ``ph: "C"``, everything else
        to ``ph: "i"`` instants."""
        pid = os.getpid()
        out = []
        for ev in self.events():
            args = dict(ev.get("args") or {})
            if "step" in ev:
                args["step"] = ev["step"]
            if "parent" in ev:
                args["parent_span"] = ev["parent"]
            if "trace" in ev:
                args["trace"] = ev["trace"]
            if "remote_parent" in ev:
                args["remote_parent"] = ev["remote_parent"]
            base = {
                "name": str(ev["name"]),
                "cat": str(ev["kind"]),
                "pid": pid,
                "tid": int(ev["tid"]),
                "ts": (ev["ts"] - self._mono0) * 1e6,   # microseconds
            }
            if ev["kind"] == "counter":
                val = args.get("value", args.get("delta", 0))
                out.append(dict(base, ph="C",
                                args={"value": float(val)}))
            elif "dur" in ev:
                out.append(dict(base, ph="X", dur=ev["dur"] * 1e6,
                                args=args))
            else:
                out.append(dict(base, ph="i", s="t", args=args))
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path
