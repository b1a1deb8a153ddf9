"""Declarative SLO monitors with rolling windows and burn-rate alerts
(the counterpart of ``paddle_tpu/observability/slo.py``).

An :class:`SLORule` names a monitor metric, an objective and a rolling
window; the :class:`SLOMonitor` evaluates every rule against windowed
*deltas* of the process-wide ``utils.monitor`` registry — the same
counters and histograms the serving engines, the Executor step anatomy
(``step.host_ms`` / ``step.device_ms``) and the fault layer already
feed — so declaring an SLO never adds a hot-path instrument.

Three rule shapes.  ``per=`` is explicit and wins; the rest is
resolved from what the metric is (``quantile=`` and ``per=`` are
mutually exclusive — a rule can't be both):

- **ratio** (``per=`` names a denominator counter): windowed
  ``Δmetric / Δper`` vs an ``objective`` fraction — shed rate,
  deadline-expiry rate.  A histogram-observed numerator counts its
  windowed *observations*.
- **quantile** (no ``per``, the metric has a histogram): the windowed
  ``quantile`` (default p99) must stay at/below ``objective`` —
  serving p99 latency, decode TTFT, training step time.
- **rate** (plain counter, no ``per``): windowed ``Δmetric /
  Δseconds`` vs an ``objective`` per-second rate.

``burn = measured / objective`` is the burn rate: 1.0 means consuming
the objective exactly; the rule breaches when ``burn >= burn_rate``
(so ``burn_rate=2`` alerts only on *fast* burns, the classic
multi-window page rule's fast arm).  Windows hold no samples of their
own: the monitor keeps timestamped snapshots of the registry and
subtracts, so an idle window (no traffic) is "no data" — healthy, not
breached.

Transitions emit ``slo`` tracer events (breach / recover) through the
one-None-check hook, set ``slo.<rule>.*`` monitor gauges (exported as
``paddle_tpu_slo_*`` by ``prometheus_text``), and drive ``/healthz``:
with a monitor installed, any breached rule degrades the endpoint to
503 with the breach reasons in the body.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

from ..core import obs_hook
from ..utils import monitor

__all__ = ["SLORule", "SLOMonitor", "install_slo_monitor",
           "uninstall_slo_monitor", "get_slo_monitor", "slo_status",
           "standard_serving_rules"]


class SLORule:
    """One service-level objective over a monitor metric.

    Args:
        metric: monitor stat/histogram name (``serving.latency_ms``,
            ``serving.shed``, ``step.device_ms``, ...).
        objective: the target — milliseconds for quantile rules, a
            fraction for ratio rules, events/second for rate rules.
        window: rolling evaluation window, seconds.
        burn_rate: breach when ``measured / objective >= burn_rate``.
        name: report/gauge label (defaults to a metric-derived slug).
        quantile: which windowed quantile a histogram metric is held
            to (default 0.99).
        per: denominator counter for ratio rules.
        min_count: a quantile rule judges only windows holding at
            least this many observations (default 1) — raise it so a
            freshly-installed monitor can't degrade ``/healthz`` off a
            handful of samples before the window has filled.
    """

    def __init__(self, metric: str, objective: float,
                 window: float = 60.0, burn_rate: float = 1.0,
                 name: Optional[str] = None,
                 quantile: Optional[float] = None,
                 per: Optional[str] = None,
                 min_count: int = 1):
        if objective <= 0:
            raise ValueError("objective must be > 0")
        if window <= 0:
            raise ValueError("window must be > 0")
        if burn_rate <= 0:
            raise ValueError("burn_rate must be > 0")
        if quantile is not None and not (0.0 < quantile < 1.0):
            raise ValueError("quantile must lie in (0, 1)")
        if quantile is not None and per is not None:
            raise ValueError(
                "quantile= and per= are mutually exclusive: a rule is "
                "either a windowed quantile of the metric or a ratio "
                "over a denominator, not both")
        if min_count < 1:
            raise ValueError("min_count must be >= 1")
        self.min_count = int(min_count)
        self.metric = str(metric)
        self.objective = float(objective)
        self.window = float(window)
        self.burn_rate = float(burn_rate)
        self.quantile = quantile
        self.per = per
        self.name = name or self.metric.replace(".", "_")

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "objective": self.objective, "window": self.window,
                "burn_rate": self.burn_rate, "quantile": self.quantile,
                "per": self.per, "min_count": self.min_count}

    def __repr__(self):
        return (f"SLORule({self.metric!r}, objective={self.objective}, "
                f"window={self.window}, burn_rate={self.burn_rate})")


# gauge value for a non-finite measurement: finite so JSON exports of
# the registry stay strict-parseable, large enough that any dashboard
# threshold alert still fires during the "unambiguously burning"
# zero-denominator condition
_INF_GAUGE = 1e12


def _json_num(v):
    """A measurement as it may be serialized: non-finite floats become
    the JSON-safe string ``"inf"``/``"-inf"`` (the bare token
    ``Infinity`` json.dumps would emit breaks strict parsers — jq,
    JSON.parse, the chrome trace viewer)."""
    if v is None or isinstance(v, str) or math.isfinite(v):
        return v
    return "inf" if v > 0 else "-inf"


def standard_serving_rules(p99_latency_ms: Optional[float] = None,
                           ttft_p95_ms: Optional[float] = None,
                           shed_ratio: Optional[float] = None,
                           expiry_ratio: Optional[float] = None,
                           step_p95_ms: Optional[float] = None,
                           window: float = 60.0) -> List[SLORule]:
    """The standard serving and training SLOs as one declarative
    bundle: pass only the objectives you serve (None skips the rule)."""
    rules: List[SLORule] = []
    if p99_latency_ms is not None:
        rules.append(SLORule("serving.latency_ms", p99_latency_ms,
                             window=window, quantile=0.99,
                             name="serving_p99_latency_ms"))
    if ttft_p95_ms is not None:
        rules.append(SLORule("serving.decode.ttft_ms", ttft_p95_ms,
                             window=window, quantile=0.95,
                             name="decode_p95_ttft_ms"))
    if shed_ratio is not None:
        rules.append(SLORule("serving.shed", shed_ratio, window=window,
                             per="serving.requests",
                             name="serving_shed_ratio"))
    if expiry_ratio is not None:
        rules.append(SLORule("serving.deadline_expired", expiry_ratio,
                             window=window, per="serving.requests",
                             name="serving_expiry_ratio"))
    if step_p95_ms is not None:
        rules.append(SLORule("step.device_ms", step_p95_ms,
                             window=window, quantile=0.95,
                             name="train_p95_step_ms"))
    return rules


class SLOMonitor:
    """Evaluates a rule set against rolling windows of the monitor
    registry.  :meth:`poll` snapshots, evaluates, updates gauges and
    emits transition events; it is cheap enough to run per ``/healthz``
    probe (that is exactly how the HTTP layer drives it)."""

    def __init__(self, rules):
        rules = list(rules)
        if not rules:
            raise ValueError("an SLOMonitor needs at least one rule")
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.rules: List[SLORule] = rules
        self._max_window = max(r.window for r in rules)
        self._metrics = sorted({m for r in rules
                                for m in (r.metric, r.per) if m})
        # reentrant: the flight recorder reads status() from the
        # SIGTERM handler, which can interrupt the SAME thread inside
        # either lock — a plain Lock would self-deadlock the crash
        # dump at exactly the preemption it exists to record
        self._lock = threading.RLock()
        # serializes whole poll() evaluations: concurrent /healthz
        # probes (ThreadingHTTPServer = one thread per connection)
        # must not interleave snapshot-append, transition detection
        # and gauge/event emission, or a breach double-fires and a
        # slow thread overwrites _last with stale status
        self._poll_lock = threading.RLock()
        self._snaps: List[tuple] = []       # (ts, {metric: entry})
        self._breached: Dict[str, bool] = {r.name: False for r in rules}
        self._last: Optional[dict] = None

    # -- snapshots ---------------------------------------------------------
    def _snapshot(self) -> dict:
        # targeted reads, not all_stats(): poll() runs per /healthz
        # probe and the registry can hold hundreds of entries (per-
        # device memory gauges, per-engine mirrors) — copying it all
        # to read the rules' few metrics is pure lock contention
        return {m: {"h": monitor.histogram_raw(m),
                    "v": monitor.get_stat(m)}
                for m in self._metrics}

    @staticmethod
    def _window_delta(cur_e: dict, base_e: Optional[dict]) -> dict:
        """cur - base for one metric entry (base None = everything)."""
        out = {"v": cur_e["v"] - (base_e["v"] if base_e else 0)}
        ch = cur_e.get("h")
        if ch is not None:
            bh = (base_e or {}).get("h")
            if bh is None:
                out["counts"] = list(ch["counts"])
                out["n"] = ch["count"]
            else:
                out["counts"] = [a - b for a, b in
                                 zip(ch["counts"], bh["counts"])]
                out["n"] = ch["count"] - bh["count"]
        return out

    # -- evaluation --------------------------------------------------------
    def _evaluate(self, rule: SLORule, cur: dict, base: Optional[dict],
                  dt: float) -> dict:
        # no base snapshot yet (first poll after install): evaluating
        # the process's whole cumulative history as "the window" would
        # alert on traffic that predates the objective — report no
        # data instead
        d = (self._window_delta(cur[rule.metric], base.get(rule.metric))
             if base is not None else {})
        measured: Optional[float] = None
        kind = "rate"
        if rule.per:        # counter ratio — explicit per= wins, even
            kind = "ratio"  # when the numerator metric has a histogram
            if base is not None:
                # a histogram-observed metric counts its windowed
                # observations, a plain counter its delta — on BOTH
                # sides: a histogram denominator's stat value is
                # always 0, which would make any numerator event an
                # inf burn and permanently degrade /healthz
                pe = cur[rule.per]
                pd = self._window_delta(pe, base.get(rule.per))
                dp = pd["n"] if pe.get("h") is not None else pd["v"]
                dv = (d["n"] if cur[rule.metric].get("h") is not None
                      else d["v"])
                if dp > 0:
                    measured = dv / dp
                elif dv > 0:    # events with zero denominator traffic:
                    measured = math.inf     # unambiguously burning
        elif cur[rule.metric].get("h") is not None:   # windowed quantile
            kind = "quantile"
            if d.get("n", 0) >= rule.min_count:
                ch = cur[rule.metric]["h"]
                # lifetime min/max bound any window's values: without
                # them a windowed p99 can overshoot the true extreme
                # by a bucket width and falsely breach the objective
                measured = monitor.quantile_from_counts(
                    d["counts"], d["n"], rule.quantile or 0.99,
                    vmin=ch["min"], vmax=ch["max"])
        else:                               # counter rate per second
            if base is not None and dt > 0 and d["v"] != 0:
                measured = d["v"] / dt
        burn = 0.0 if measured is None else measured / rule.objective
        return {"name": rule.name, "metric": rule.metric, "kind": kind,
                "objective": rule.objective, "window": rule.window,
                "burn_rate": rule.burn_rate,
                "quantile": rule.quantile, "per": rule.per,
                "measured": (None if measured is None
                             else float(measured)),
                "burn": float(burn),
                "breached": measured is not None
                and burn >= rule.burn_rate}

    def poll(self, now: Optional[float] = None) -> dict:
        """Snapshot the registry, evaluate every rule over its window,
        update gauges and transition events; returns the status dict.
        ``now`` (monotonic seconds) is injectable for deterministic
        window tests."""
        with self._poll_lock:
            return self._poll_locked(now)

    def _poll_locked(self, now: Optional[float]) -> dict:
        now = time.monotonic() if now is None else float(now)
        cur = self._snapshot()
        with self._lock:
            self._snaps.append((now, cur))
            # retain one snapshot older than the longest window so a
            # full-window base survives pruning
            cutoff = now - self._max_window
            while len(self._snaps) > 2 and self._snaps[1][0] <= cutoff:
                self._snaps.pop(0)
            snaps = list(self._snaps)
            prev_breached = dict(self._breached)
        results = []
        for rule in self.rules:
            base_ts, base = None, None
            target = now - rule.window
            for ts, snap in snaps[:-1]:
                if ts <= target or base_ts is None:
                    base_ts, base = ts, snap
                if ts > target:
                    break
            res = self._evaluate(rule, cur, base,
                                 now - base_ts if base_ts is not None
                                 else 0.0)
            res["window_actual"] = (now - base_ts
                                    if base_ts is not None else 0.0)
            results.append(res)
        # gauges + transitions (outside the lock: monitor locks itself)
        trc = obs_hook._tracer
        reasons = []
        for res in results:
            nm = res["name"]
            b = res["burn"]
            monitor.stat_set(f"slo.{nm}.burn",
                             round(b, 6) if math.isfinite(b)
                             else _INF_GAUGE)
            monitor.stat_set(f"slo.{nm}.breached", int(res["breached"]))
            m = res["measured"]
            if m is not None:
                monitor.stat_set(f"slo.{nm}.measured",
                                 round(m, 6) if math.isfinite(m)
                                 else _INF_GAUGE)
            else:
                # no data this window: drop the gauge rather than
                # freeze it at the last (possibly breach-level) value
                monitor.stat_reset(f"slo.{nm}.measured")
            was = prev_breached.get(nm, False)
            if res["breached"] and not was:
                monitor.stat_add("slo.breaches")
                if trc is not None:
                    # event args land verbatim in flight dumps and
                    # chrome-trace exports: keep them strict-JSON-safe
                    trc.emit("slo", "breach", args=dict(
                        rule=nm, metric=res["metric"],
                        measured=_json_num(res["measured"]),
                        objective=res["objective"],
                        burn=_json_num(res["burn"])))
            elif was and not res["breached"]:
                if trc is not None:
                    trc.emit("slo", "recover", args=dict(
                        rule=nm, measured=_json_num(res["measured"]),
                        objective=res["objective"]))
            if res["breached"]:
                m = res["measured"]
                reasons.append(
                    f"{nm}: measured "
                    f"{'inf' if not math.isfinite(m) else round(m, 3)} "
                    f"vs objective {res['objective']} over "
                    f"{res['window']}s (burn {res['burn']:.2f}x)")
        degraded = bool(reasons)
        monitor.stat_set("slo.degraded", int(degraded))
        # the status dict is serialized verbatim (/perf responses,
        # dump_metrics JSONL, flight dumps): a zero-denominator ratio's
        # math.inf would render as the non-standard token Infinity and
        # break strict JSON consumers — carry it as the string "inf"
        for res in results:
            for k in ("measured", "burn"):
                res[k] = _json_num(res[k])
        status = {
            "installed": True,
            "status": "degraded" if degraded else "ok",
            "time": time.time(),
            "rules": results,
            "breached": [r["name"] for r in results if r["breached"]],
            "reasons": reasons,
        }
        with self._lock:
            for res in results:
                self._breached[res["name"]] = res["breached"]
            self._last = status
        return status

    def status(self) -> Optional[dict]:
        """The most recent :meth:`poll` result (None before the first)."""
        with self._lock:
            return self._last


_lock = threading.Lock()
_monitor: Optional[SLOMonitor] = None


def _clear_rule_gauges(m: Optional[SLOMonitor]) -> None:
    """Remove an outgoing monitor's per-rule gauges from the registry:
    a dashboard must not keep seeing ``slo.<rule>.breached 1`` from a
    monitor that no longer exists."""
    if m is None:
        return
    for rule in m.rules:
        for suffix in ("burn", "breached", "measured"):
            monitor.stat_reset(f"slo.{rule.name}.{suffix}")


def install_slo_monitor(rules) -> SLOMonitor:
    """Install a process-wide monitor over ``rules`` (a list of
    :class:`SLORule`, or anything :class:`SLOMonitor` accepts);
    replaces any previous one (whose per-rule gauges are cleared).
    Returns the monitor."""
    global _monitor
    m = rules if isinstance(rules, SLOMonitor) else SLOMonitor(rules)
    with _lock:
        prev, _monitor = _monitor, m
    if prev is not m:
        _clear_rule_gauges(prev)
    monitor.stat_set("slo.degraded", 0)
    return m


def uninstall_slo_monitor() -> None:
    global _monitor
    with _lock:
        prev, _monitor = _monitor, None
    _clear_rule_gauges(prev)
    monitor.stat_set("slo.degraded", 0)


def get_slo_monitor() -> Optional[SLOMonitor]:
    return _monitor


def slo_status(poll: bool = True) -> dict:
    """Current SLO state.  With no monitor installed: ``{"installed":
    False, "status": "ok"}`` — absence of objectives is healthy, not
    unknown.  ``poll=False`` returns the last evaluation without
    re-snapshotting (what flight dumps embed)."""
    m = _monitor
    if m is None:
        return {"installed": False, "status": "ok", "rules": [],
                "breached": [], "reasons": []}
    if poll:
        return m.poll()
    st = m.status()
    return st if st is not None else {
        "installed": True, "status": "ok", "rules": [], "breached": [],
        "reasons": []}
