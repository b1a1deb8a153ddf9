"""Metrics export: monitor gauges + histograms as Prometheus text or
JSON (the counterpart of ``paddle_tpu/observability/metrics.py``).

One exporter for every telemetry island: ``monitor.all_stats()`` /
``all_histograms()`` (which the serving engines, the checkpoint store,
the fault injector and compile attribution all feed) render as

- **Prometheus text exposition** (:func:`prometheus_text`) — gauges per
  stat, ``summary`` metrics per histogram (p50/p95/p99 quantile labels
  plus ``_sum``/``_count``), names sanitized to the Prometheus charset
  under paddle_tpu's ``paddle_tpu_`` prefix, so a scraper reads both
  packages alike.  ``serving/http.py`` serves this from ``/metrics``
  when the scraper's Accept header asks for text.
- **JSON snapshots** (:func:`metrics_snapshot`) — the same registry as
  one timestamped dict, appendable as JSONL via :func:`dump_metrics`
  (``FLAGS_metrics_dump_path``, rotated by ``FLAGS_metrics_dump_max_mb``
  and ``FLAGS_metrics_dump_keep``).
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, Optional

from ..core import flags, obs_hook
from ..utils import monitor

__all__ = ["prometheus_text", "metrics_snapshot", "dump_metrics",
           "build_info"]

_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "paddle_tpu_"

_build_info_cache: Optional[dict] = None


def build_info() -> dict:
    """Version and device identity of this process — the fleet view
    diffs it across replicas to flag version skew.  Names the port,
    torch, CUDA and the card; never initializes CUDA itself: until the
    process has touched the card, ``device`` is ``"uninitialized"``
    (and the answer is not cached, so a later call names the card)."""
    global _build_info_cache
    if _build_info_cache is not None:
        return dict(_build_info_cache)
    import torch
    from .. import __version__
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info = {
        "framework": __version__,
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "backend": "cuda" if count else "cpu",
        "device_count": int(count),
    }
    if not count:
        info["device"] = "cpu"
    elif torch.cuda.is_initialized():
        info["device"] = torch.cuda.get_device_name(0)
    else:
        info["device"] = "uninitialized"
        return info
    _build_info_cache = info
    return dict(info)


def _prom_name(name: str) -> str:
    n = _PREFIX + _BAD.sub("_", name)
    return n


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _esc_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(extra_gauges: Optional[Dict[str, float]] = None
                    ) -> str:
    """The whole monitor registry (plus caller-supplied gauges) in
    Prometheus text exposition format (version 0.0.4).

    An ``extra_gauges`` key may carry a label set after the name —
    ``'serving_engine_queue_depth{engine="bert"}'`` — the name part is
    sanitized, the label part passes through verbatim (the serving
    front-end's per-engine labels ride this).  An extra gauge whose
    sanitized name matches a monitor-stat family joins that family
    (one ``# TYPE`` line, samples contiguous — strict parsers reject
    repeated or split families); an exact duplicate series (same name,
    same label set) is skipped, the registry's value wins."""
    t = obs_hook._tracer
    if t is not None:
        t.ring_stats()      # refresh the drop-accounting gauges
    stats = monitor.all_stats()
    hists = monitor.all_histograms()
    hist_names = {_prom_name(n) for n in hists}
    # family name -> (type, sample lines, label sets seen); insertion-
    # ordered so each family renders once, contiguously
    families: Dict[str, tuple] = {}

    def fam(m: str, typ: str) -> tuple:
        f = families.get(m)
        if f is None:
            f = families[m] = (typ, [], set())
        return f

    for name in sorted(stats):
        m = _prom_name(name)
        if m in hist_names:     # a stat and a histogram sharing a name
            m += "_stat"        # must not collide in the exposition
        _, smp, seen = fam(m, "gauge")
        smp.append(f"{m} {_fmt(stats[name])}")
        seen.add("")
    for name in sorted(hists):
        m = _prom_name(name)
        s = hists[name]
        _, smp, _ = fam(m, "summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            smp.append(f'{m}{{quantile="{q}"}} {_fmt(s[key])}')
        smp.append(f"{m}_sum {_fmt(s['sum'])}")
        smp.append(f"{m}_count {_fmt(int(s['count']))}")
    for name in sorted(extra_gauges or {}):
        base, brace, label = name.partition("{")
        m = _prom_name(base)
        if m in hist_names:
            m += "_stat"
        _, smp, seen = fam(m, "gauge")
        key = brace + label
        if key in seen:
            continue
        seen.add(key)
        smp.append(f"{m}{key} {_fmt(extra_gauges[name])}")
    bi = build_info()
    labels = ",".join(f'{k}="{_esc_label(v)}"'
                      for k, v in sorted(bi.items()))
    _, smp, _ = fam(_PREFIX + "build_info", "gauge")
    smp.append(f"{_PREFIX}build_info{{{labels}}} 1")
    lines = []
    for m, (typ, smp, _) in families.items():
        lines.append(f"# TYPE {m} {typ}")
        lines.extend(smp)
    return "\n".join(lines) + "\n"


def metrics_snapshot(extra: Optional[dict] = None) -> dict:
    """Timestamped JSON-ready snapshot of every stat and histogram,
    plus — when the respective layers are live — the tracer's drop
    accounting (``obs``), the current SLO evaluation (``slo``), and
    the perf observatory's drift report (``perf``), so one JSONL line
    is a complete offline-analysis record (latency distributions and
    objective state included, not just counters)."""
    t = obs_hook._tracer
    ring = t.ring_stats() if t is not None else None
    snap = {
        "time": time.time(),
        "stats": monitor.all_stats(),
        "histograms": monitor.all_histograms(),
        "build": build_info(),
    }
    if ring is not None:
        snap["obs"] = ring
    from . import slo as _slo
    if _slo.get_slo_monitor() is not None:
        snap["slo"] = _slo.slo_status(poll=False)
    p = obs_hook._perf
    if p is not None:
        snap["perf"] = p.report()
    if extra:
        snap.update(extra)
    return snap


def _rotate_dump(path: str) -> None:
    """Size-based rotation for the JSONL flight file: at/above
    ``FLAGS_metrics_dump_max_mb`` MiB, shift ``path.i`` -> ``path.i+1``
    (dropping the one past ``FLAGS_metrics_dump_keep``) and move the
    live file to ``path.1`` via atomic rename, so a long-lived replica
    never grows one unbounded file and a crash mid-rotation never loses
    the live file (rename is the last step)."""
    max_mb = float(flags.get_flag("metrics_dump_max_mb"))
    if max_mb <= 0:
        return
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size < max_mb * (1 << 20):
        return
    keep = max(1, int(flags.get_flag("metrics_dump_keep")))
    oldest = f"{path}.{keep}"
    if os.path.exists(oldest):
        os.remove(oldest)
    for i in range(keep - 1, 0, -1):
        src = f"{path}.{i}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i + 1}")
    os.replace(path, f"{path}.1")


def dump_metrics(path: Optional[str] = None,
                 extra: Optional[dict] = None) -> str:
    """Append one :func:`metrics_snapshot` line to the JSONL flight
    file at ``path`` (default ``FLAGS_metrics_dump_path``); rotates the
    file first when ``FLAGS_metrics_dump_max_mb`` is set and the file
    has outgrown it."""
    path = path or flags.get_flag("metrics_dump_path")
    if not path:
        raise ValueError(
            "no metrics dump path: pass path= or set "
            "FLAGS_metrics_dump_path")
    _rotate_dump(path)
    with open(path, "a") as f:
        f.write(json.dumps(metrics_snapshot(extra)) + "\n")
    return path
