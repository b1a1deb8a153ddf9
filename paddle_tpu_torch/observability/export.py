"""Per-process telemetry exporter: spool metrics + trace for the fleet
(the counterpart of ``paddle_tpu/observability/export.py``).

Every observability surface in this tree is per-process; the fleet
(supervised training children, serving replicas, their parents) needs
one view.  This module is the producing half: when
``FLAGS_obs_spool_dir`` is set the process periodically spools

- ``meta.json`` — role, pid, start time and :func:`..metrics.build_info`
  (the fleet view diffs the build block across processes to flag
  version skew), written once at install;
- ``metrics.json`` — the latest :func:`..metrics.metrics_snapshot`,
  atomically overwritten each flush;
- ``trace-NNNNNN.json`` — tracer-ring segments: the events emitted
  since the previous flush, wall-clock stamped (``Tracer.jsonable``) so
  the aggregator (:mod:`.fleet`) can align lanes across processes
  whose monotonic clocks share no epoch;

into ``<spool_dir>/<role>-<pid>/``, each document wrapped as
``{"sha256": ..., "body": ...}`` and written through a temporary
file and a rename (``utils.checkpoint.write_atomic``) —
a reader never sees a torn file, and a corrupt one is detected, not
merged.

Enablement: with ``FLAGS_obs_spool_dir`` set in the environment,
``paddle_tpu_torch/__init__`` installs the exporter at import, so a
child process spawned with the flag exports with no code change.  Off,
instrumented hot paths pay one module-attribute None-check on
``obs_hook._export`` (the same contract as ``_tracer``/``_perf``).

Flush cadence: a daemon thread fires every
``FLAGS_obs_export_interval_s``; hot paths also call :meth:`tick`
(rate-limited to a time comparison) so a process that dies between
timer fires (killed with SIGKILL) still
leaves a spool no older than one interval of work.  A final flush runs
at interpreter exit for clean shutdowns.
"""
from __future__ import annotations

import atexit
import hashlib
import json
import os
import threading
import time
from typing import Optional

from ..core import flags, obs_hook

__all__ = ["TelemetryExporter", "install_exporter", "uninstall_exporter",
           "get_exporter", "checksum_wrap", "checksum_unwrap"]


def checksum_wrap(body: dict) -> bytes:
    """Serialize ``body`` with an embedded sha256 over its canonical
    JSON form."""
    text = json.dumps(body, sort_keys=True, default=str)
    digest = hashlib.sha256(text.encode()).hexdigest()
    return json.dumps({"sha256": digest, "body": json.loads(text)},
                      sort_keys=True).encode()


def checksum_unwrap(data: bytes) -> dict:
    """Parse a :func:`checksum_wrap` document, verifying the digest.
    Raises ``ValueError`` on a missing or mismatched checksum."""
    doc = json.loads(data)
    if not isinstance(doc, dict) or "sha256" not in doc:
        raise ValueError("not a checksummed telemetry document")
    body = doc.get("body")
    text = json.dumps(body, sort_keys=True, default=str)
    digest = hashlib.sha256(text.encode()).hexdigest()
    if digest != doc["sha256"]:
        raise ValueError(
            f"telemetry checksum mismatch: {doc['sha256']} != {digest}")
    return body


class TelemetryExporter:
    """Spools this process's metrics + trace segments for the fleet
    aggregator.  Install via :func:`install_exporter` (or let
    ``paddle_tpu_torch/__init__`` do it from ``FLAGS_obs_spool_dir``)."""

    def __init__(self, spool_dir: str, role: Optional[str] = None,
                 interval_s: Optional[float] = None):
        self.role = str(role or flags.get_flag("obs_role") or "proc")
        self.pid = os.getpid()
        self.interval_s = max(0.05, float(
            interval_s if interval_s is not None
            else flags.get_flag("obs_export_interval_s")))
        self.dir = os.path.join(str(spool_dir),
                                f"{self.role}-{self.pid}")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        self._last_flush = 0.0          # first tick() flushes
        self._spooled_ids: set = set()  # ids already segmented, bounded
                                        # by the ring (reset to its
                                        # current contents each flush)
        self._seq = 0
        self.flushes = 0
        self.errors = 0
        self._closed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._write_meta()

    # -- spool writers -----------------------------------------------------
    def _write(self, name: str, body: dict) -> None:
        from ..utils.checkpoint import write_atomic
        write_atomic(os.path.join(self.dir, name), checksum_wrap(body))

    def _write_meta(self) -> None:
        from .metrics import build_info
        self._write("meta.json", {
            "role": self.role,
            "pid": self.pid,
            "start_time": time.time(),
            "interval_s": self.interval_s,
            "build": build_info(),
        })

    def tick(self, now: Optional[float] = None) -> bool:
        """Hot-path entry: flush if an interval has passed since the
        last flush, else return immediately (one time comparison).
        Returns whether a flush happened."""
        now = time.monotonic() if now is None else now
        if now - self._last_flush < self.interval_s:
            return False
        return self.flush(now=now)

    def flush(self, now: Optional[float] = None) -> bool:
        """Spool the latest metrics snapshot and any new tracer events
        now.  Never raises (a telemetry failure must not take down the
        process it observes); failures are counted on ``errors``."""
        with self._lock:
            if self._closed:
                return False
            self._last_flush = (time.monotonic() if now is None
                                else now)
            try:
                self._flush_locked()
                self.flushes += 1
                return True
            except Exception:
                self.errors += 1
                return False

    def _flush_locked(self) -> None:
        from .metrics import metrics_snapshot
        self._write("metrics.json", {
            "role": self.role, "pid": self.pid,
            "snapshot": metrics_snapshot(),
        })
        trc = obs_hook._tracer
        if trc is None:
            return
        # "new since last flush" by event id, not position: a span's
        # event carries the id allocated at begin_span but is emitted
        # at end_span, so a long span lands out of id order and a
        # high-watermark filter would drop it
        evs = trc.events()
        fresh = [trc.jsonable(e) for e in evs
                 if e["id"] not in self._spooled_ids]
        self._spooled_ids = {e["id"] for e in evs}
        if not fresh:
            return
        self._seq += 1
        self._write(f"trace-{self._seq:06d}.json", {
            "role": self.role, "pid": self.pid, "seq": self._seq,
            "events": fresh,
        })

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "TelemetryExporter":
        """Arm the periodic flush thread and the exit-time flush."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="obs-export", daemon=True)
            self._thread.start()
            atexit.register(self.close)
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()

    def close(self) -> None:
        """Final flush + stop the timer thread.  Idempotent."""
        self._stop.set()
        self.flush()
        with self._lock:
            self._closed = True


def install_exporter(spool_dir: Optional[str] = None,
                     role: Optional[str] = None,
                     interval_s: Optional[float] = None
                     ) -> Optional[TelemetryExporter]:
    """Install (and return) the process telemetry exporter.

    ``spool_dir`` defaults to ``FLAGS_obs_spool_dir``; with neither
    set this is a no-op returning None.  If no tracer is live one is
    enabled — a spool without a trace lane defeats the point — and the
    exporter lands in ``obs_hook._export`` for hot-path ticks."""
    spool_dir = spool_dir or flags.get_flag("obs_spool_dir")
    if not spool_dir:
        return None
    prev = obs_hook._export
    if prev is not None:
        prev.close()
    if obs_hook._tracer is None:
        from . import enable
        enable()
    exp = TelemetryExporter(spool_dir, role=role,
                            interval_s=interval_s).start()
    obs_hook.set_export(exp)
    exp.flush()
    return exp


def uninstall_exporter() -> None:
    exp = obs_hook._export
    obs_hook.set_export(None)
    if exp is not None:
        exp.close()


def get_exporter() -> Optional[TelemetryExporter]:
    return obs_hook._export
