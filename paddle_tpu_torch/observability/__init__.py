"""paddle_tpu_torch.observability — tracing, metrics and post-mortems
(the counterpart of ``paddle_tpu/observability``).

- :func:`enable` installs a process-wide :class:`Tracer` — a ring
  buffer of typed events (spans, eager op dispatches, compiles,
  checkpoint save/restore/fallback, serving dispatches and swaps, fault
  fires) with step/request correlation ids, exportable as chrome-trace
  JSON or JSONL.  Disabled (the default), every instrumented hot path
  pays one module-attribute None-check (``core.obs_hook``).
- :func:`explain_compiles` attributes every new variant the static
  Executor, ``to_static``, the inference Predictor and the generation
  engine built to a named cause, with a diff against the previous
  signature — always on, counted per cause in ``monitor``.
- :func:`prometheus_text` / :func:`metrics_snapshot` /
  :func:`dump_metrics` export the monitor registry as Prometheus text
  or JSON (``serving/http.py`` content-negotiates ``/metrics``).
- :func:`install_flight_recorder` arms the crash flight recorder:
  ``EnforceError``, Executor exceptions, SIGTERM and
  ``sys.excepthook`` dump the last N events and the metrics.
- :func:`enable_perf` installs the performance observatory
  (:mod:`.perf`): sampled step anatomy (host lane, device lane by CUDA
  events), per-card memory, predicted-vs-measured drift.
- :func:`install_slo_monitor` (:mod:`.slo`) evaluates declarative
  :class:`SLORule` burn-rate rules over the monitor registry;
  :func:`slo_status` drives ``/healthz`` degradation.
- :func:`install_exporter` (:mod:`.export`) spools this process's
  metrics and trace under ``FLAGS_obs_spool_dir`` for the fleet
  aggregator (:mod:`.fleet`): :func:`fleet_snapshot`,
  :func:`fleet_prometheus_text`, :func:`merged_chrome_trace`,
  :func:`assemble_trace` and :class:`FleetView` behind
  ``GET /admin/fleet``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from ..core import obs_hook
from .compiles import (annotate_compile, explain_compiles,
                       record_compile, reset_compiles)
from .export import (TelemetryExporter, get_exporter, install_exporter,
                     uninstall_exporter)
from .fleet import (FleetView, assemble_trace, collect_fleet_bundle,
                    fleet_prometheus_text, fleet_snapshot,
                    merged_chrome_trace, read_spool)
from .flight import (dump_flight, flight_recorder_path,
                     install_flight_recorder, uninstall_flight_recorder)
from .metrics import (build_info, dump_metrics, metrics_snapshot,
                      prometheus_text)
from .perf import (PerfObservatory, device_memory, disable_perf,
                   enable_perf, get_perf, perf_enabled, perf_report,
                   render_perf_report)
from .slo import (SLOMonitor, SLORule, get_slo_monitor,
                  install_slo_monitor, slo_status,
                  standard_serving_rules, uninstall_slo_monitor)
from .tracer import EVENT_KINDS, Tracer

__all__ = [
    "Tracer", "EVENT_KINDS", "enable", "disable", "enabled",
    "get_tracer", "emit", "span", "counter", "set_step",
    "record_compile", "explain_compiles", "reset_compiles",
    "annotate_compile",
    "prometheus_text", "metrics_snapshot", "dump_metrics", "build_info",
    "install_flight_recorder", "uninstall_flight_recorder",
    "dump_flight", "flight_recorder_path",
    "TelemetryExporter", "install_exporter", "uninstall_exporter",
    "get_exporter",
    "FleetView", "read_spool", "fleet_snapshot", "fleet_prometheus_text",
    "merged_chrome_trace", "assemble_trace", "collect_fleet_bundle",
    "PerfObservatory", "enable_perf", "disable_perf", "perf_enabled",
    "get_perf", "perf_report", "render_perf_report", "device_memory",
    "SLORule", "SLOMonitor", "install_slo_monitor",
    "uninstall_slo_monitor", "get_slo_monitor", "slo_status",
    "standard_serving_rules",
]


def enable(capacity: int = 8192, trace_ops: bool = True) -> Tracer:
    """Install (and return) a fresh process-wide tracer."""
    t = Tracer(capacity=capacity, trace_ops=trace_ops)
    obs_hook.set_tracer(t)
    return t


def disable() -> None:
    """Remove the tracer; instrumented sites return to the one
    None-check disabled path."""
    obs_hook.set_tracer(None)


def enabled() -> bool:
    return obs_hook.current() is not None


def get_tracer() -> Optional[Tracer]:
    return obs_hook.current()


def emit(kind: str, name: str, **args) -> None:
    """Emit one event on the active tracer; no-op when disabled."""
    t = obs_hook._tracer
    if t is not None:
        t.emit(kind, name, args=args or None)


def counter(name: str, delta=1, value=None) -> None:
    """Emit a counter-delta event; no-op when disabled."""
    t = obs_hook._tracer
    if t is not None:
        t.counter(name, delta, value=value)


def set_step(step: int) -> None:
    """Set the step correlation id on the active tracer (no-op when
    disabled)."""
    t = obs_hook._tracer
    if t is not None:
        t.set_step(step)


@contextlib.contextmanager
def span(name: str, **args):
    """Span context manager; a no-op (still yields) when disabled."""
    t = obs_hook._tracer
    if t is None:
        yield None
        return
    sid = t.begin_span(name, **args)
    try:
        yield sid
    finally:
        t.end_span(sid)
