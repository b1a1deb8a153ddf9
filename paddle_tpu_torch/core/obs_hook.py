"""Observability hook slots shared by instrumented layers (the
counterpart of ``paddle_tpu/core/obs_hook.py``).

Hot paths (eager dispatch, ``Executor.run``, the serving dispatchers)
read ``obs_hook._tracer`` (and the other slots) directly and touch the
object only when it is not None, so an uninstrumented process pays one
module-attribute None-check per site.  The crash hook ``_crash`` gates
the flight recorder the same way.  ``_heartbeat`` is a supervised
child's ``distributed.supervisor.HeartbeatWriter`` (the Executor and
the serving engines beat it), ``_anomaly`` an installed
``distributed.AnomalyPolicy`` (the Executor hands it each sentry
scan).

This module must stay import-free: core, utils, io and serving all
pull it in, and a single stray import here would cycle."""
from __future__ import annotations

_tracer = None      # observability.Tracer when enabled
_crash = None       # callable(exc, context_str) when a flight
                    # recorder is installed
_perf = None        # observability.perf.PerfObservatory when the
                    # performance observatory is on
_heartbeat = None   # supervised-liveness writer with beat(step)
_anomaly = None     # data-plane anomaly policy
_export = None      # observability.export.TelemetryExporter when this
                    # process spools telemetry (FLAGS_obs_spool_dir)


def set_tracer(tracer) -> None:
    global _tracer
    _tracer = tracer


def current():
    return _tracer


def set_perf(perf) -> None:
    global _perf
    _perf = perf


def current_perf():
    return _perf


def set_crash_handler(fn) -> None:
    global _crash
    _crash = fn


def crash_handler():
    return _crash


def set_heartbeat(hb) -> None:
    global _heartbeat
    _heartbeat = hb


def current_heartbeat():
    return _heartbeat


def set_anomaly_policy(policy) -> None:
    global _anomaly
    _anomaly = policy


def current_anomaly_policy():
    return _anomaly


def set_export(exporter) -> None:
    global _export
    _export = exporter


def current_export():
    return _export
