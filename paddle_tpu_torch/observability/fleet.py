"""Fleet aggregator: one timeline / one metrics view across processes
(the counterpart of ``paddle_tpu/observability/fleet.py``).

The consuming half of :mod:`.export`: serving replicas and any other
processes with ``FLAGS_obs_spool_dir`` set each spool checksummed
telemetry under ``FLAGS_obs_spool_dir/<role>-<pid>/``; this module
merges those spools (plus the calling process's live tracer) into

- :func:`fleet_snapshot` — every process's latest metrics snapshot and
  build identity keyed by ``<role>-<pid>``, with cross-process
  version-skew detection (``build_skew``);
- :func:`fleet_prometheus_text` — one Prometheus exposition where every
  family carries a ``{proc="<role>-<pid>"}`` label per process, family
  blocks contiguous (the PR-9 grammar contract);
- :func:`merged_chrome_trace` — one chrome-trace with a lane (pid) per
  process.  Lanes are aligned on the WALL clock: each process's
  ``Tracer.jsonable`` stamps every event with ``time`` (its own
  ``perf_counter``/``time.time`` anchor pair), and the merger rebases
  everything onto the earliest wall stamp.  Alignment is therefore as
  good as the hosts' clocks — on one machine (a parent and its children)
  that is sub-millisecond; across machines it inherits NTP skew;
- :func:`assemble_trace` — the span tree of one distributed request:
  events carrying a trace id (adopted from ``X-Trace-Id`` by the HTTP
  plane, inherited by engine/registry/supervisor events) plus the
  rid/sid-correlated scheduler events they admit, with an end-to-end
  connectivity verdict;
- :func:`collect_fleet_bundle` — the fleet flight bundle: on a
  registry incident (an elasticity shed decision), copy every child's black
  box (spool dirs, kill-time flight dumps) next to the parent's and
  write the merged views beside them, so the post-mortem starts from
  one directory.

:class:`FleetView` is the live counterpart for the registry control
plane: it aggregates per-replica readiness/SLO/inflight by scraping
registered replicas' ``/healthz`` + ``/metrics`` — ``GET /admin/fleet``
serves its :meth:`~FleetView.snapshot`.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..core import flags, obs_hook
from .export import checksum_unwrap
from .metrics import _esc_label, _fmt, _prom_name, build_info

__all__ = ["read_spool", "fleet_snapshot", "fleet_prometheus_text",
           "merged_chrome_trace", "assemble_trace",
           "collect_fleet_bundle", "FleetView"]


# ---------------------------------------------------------------------------
# Spool reading
# ---------------------------------------------------------------------------

def _read_doc(path: str) -> Optional[dict]:
    try:
        with open(path, "rb") as f:
            return checksum_unwrap(f.read())
    except Exception:
        return None


def read_spool(spool_dir: Optional[str] = None) -> List[dict]:
    """Parse every per-process spool under ``spool_dir`` (default
    ``FLAGS_obs_spool_dir``).  Returns one record per process directory:
    ``{"label", "role", "pid", "dir", "meta", "metrics", "events",
    "segments", "corrupt"}`` — events deduped by id, sorted by wall
    time.  Corrupt documents (torn before ``write_atomic`` landed, or
    checksum-mismatched) are counted, never merged."""
    spool_dir = spool_dir or flags.get_flag("obs_spool_dir")
    procs: List[dict] = []
    if not spool_dir or not os.path.isdir(spool_dir):
        return procs
    for name in sorted(os.listdir(spool_dir)):
        d = os.path.join(spool_dir, name)
        if not os.path.isdir(d):
            continue
        if os.path.exists(os.path.join(d, "bundle.json")):
            continue        # an incident bundle parked in the spool dir
                            # is a copy of the fleet, not a process
        proc = {"label": name, "dir": d, "meta": None, "metrics": None,
                "events": [], "segments": 0, "corrupt": 0}
        meta = _read_doc(os.path.join(d, "meta.json"))
        if meta is not None:
            proc["meta"] = meta
        mdoc = _read_doc(os.path.join(d, "metrics.json"))
        if mdoc is not None:
            proc["metrics"] = mdoc.get("snapshot")
        elif os.path.exists(os.path.join(d, "metrics.json")):
            proc["corrupt"] += 1
        seen: set = set()
        for seg in sorted(glob.glob(os.path.join(d, "trace-*.json"))):
            body = _read_doc(seg)
            if body is None:
                proc["corrupt"] += 1
                continue
            proc["segments"] += 1
            for ev in body.get("events") or []:
                if ev.get("id") in seen:
                    continue        # hot-path tick raced the timer flush
                seen.add(ev.get("id"))
                proc["events"].append(ev)
        proc["events"].sort(key=lambda e: e.get("time", 0.0))
        role, _, pid = name.rpartition("-")
        if meta is not None:
            proc["role"] = meta.get("role", role or name)
            proc["pid"] = int(meta.get("pid", 0) or 0)
        else:
            proc["role"] = role or name
            proc["pid"] = int(pid) if pid.isdigit() else 0
        procs.append(proc)
    return procs


def _self_proc() -> Optional[dict]:
    """The calling process's live tracer as a spool-shaped record (the
    aggregating parent is part of the fleet too)."""
    trc = obs_hook._tracer
    if trc is None:
        return None
    role = flags.get_flag("obs_role") or "proc"
    from .metrics import metrics_snapshot
    return {"label": f"{role}-{os.getpid()}", "role": role,
            "pid": os.getpid(), "dir": None, "meta": None,
            "metrics": metrics_snapshot(),
            "events": [trc.jsonable(e) for e in trc.events()],
            "segments": 0, "corrupt": 0}


def _merge_self(procs: List[dict]) -> List[dict]:
    """Union the live tracer into the spool view: the self record's
    ring may hold events newer than the last flush, the spool may hold
    events the ring already evicted — merge by id, live last."""
    me = _self_proc()
    if me is None:
        return procs
    out = []
    merged = False
    for proc in procs:
        if proc.get("pid") == me["pid"]:
            seen = {e.get("id") for e in proc["events"]}
            proc = dict(proc, metrics=me["metrics"], events=(
                proc["events"] + [e for e in me["events"]
                                  if e.get("id") not in seen]))
            proc["events"].sort(key=lambda e: e.get("time", 0.0))
            merged = True
        out.append(proc)
    if not merged:
        out.append(me)
    return out


# ---------------------------------------------------------------------------
# Merged views
# ---------------------------------------------------------------------------

def fleet_snapshot(spool_dir: Optional[str] = None,
                   procs: Optional[Sequence[dict]] = None,
                   include_self: bool = True) -> dict:
    """One fleet-wide snapshot: per-process metrics + build identity,
    with build-skew detection (distinct build blocks across processes
    — a hot-swap fleet running mixed torch/CUDA versions is flagged
    here before it becomes a weight-compatibility incident)."""
    if procs is None:
        procs = read_spool(spool_dir)
        if include_self:
            procs = _merge_self(list(procs))
    builds: Dict[str, List[str]] = {}
    out_procs = {}
    for proc in procs:
        meta = proc.get("meta") or {}
        snap = proc.get("metrics") or {}
        build = (meta.get("build") or snap.get("build")
                 or (build_info() if proc.get("dir") is None else None))
        if build:
            builds.setdefault(
                json.dumps(build, sort_keys=True), []).append(
                    proc["label"])
        out_procs[proc["label"]] = {
            "role": proc.get("role"),
            "pid": proc.get("pid"),
            "build": build,
            "metrics": snap,
            "events": len(proc.get("events") or ()),
            "segments": proc.get("segments", 0),
            "corrupt": proc.get("corrupt", 0),
        }
    return {
        "time": time.time(),
        "procs": out_procs,
        "build_skew": (sorted(builds.values(), key=len)
                       if len(builds) > 1 else []),
    }


def fleet_prometheus_text(spool_dir: Optional[str] = None,
                          procs: Optional[Sequence[dict]] = None,
                          include_self: bool = True) -> str:
    """Every process's stats/histograms as one Prometheus exposition,
    each sample labelled ``{proc="<role>-<pid>"}``.  Families render
    once, contiguously, with one ``# TYPE`` line (the same grammar
    contract :func:`..metrics.prometheus_text` keeps)."""
    if procs is None:
        procs = read_spool(spool_dir)
        if include_self:
            procs = _merge_self(list(procs))
    procs = [p for p in procs if p.get("metrics")]
    hist_names = set()
    for proc in procs:
        for n in (proc["metrics"].get("histograms") or {}):
            hist_names.add(_prom_name(n))
    families: Dict[str, tuple] = {}

    def fam(m: str, typ: str) -> tuple:
        f = families.get(m)
        if f is None:
            f = families[m] = (typ, [])
        return f

    stat_names = sorted({n for p in procs
                         for n in (p["metrics"].get("stats") or {})})
    for name in stat_names:
        m = _prom_name(name)
        if m in hist_names:
            m += "_stat"
        _, smp = fam(m, "gauge")
        for proc in procs:
            v = (proc["metrics"].get("stats") or {}).get(name)
            if v is None:
                continue
            smp.append(f'{m}{{proc="{_esc_label(proc["label"])}"}} '
                       f"{_fmt(v)}")
    h_names = sorted({n for p in procs
                      for n in (p["metrics"].get("histograms") or {})})
    for name in h_names:
        m = _prom_name(name)
        _, smp = fam(m, "summary")
        for proc in procs:
            s = (proc["metrics"].get("histograms") or {}).get(name)
            if s is None:
                continue
            pl = f'proc="{_esc_label(proc["label"])}"'
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                smp.append(f'{m}{{{pl},quantile="{q}"}} {_fmt(s[key])}')
            smp.append(f"{m}_sum{{{pl}}} {_fmt(s['sum'])}")
            smp.append(f"{m}_count{{{pl}}} {_fmt(int(s['count']))}")
    _, smp = fam(_prom_name("build_info"), "gauge")
    for proc in procs:
        build = ((proc.get("meta") or {}).get("build")
                 or (proc["metrics"] or {}).get("build"))
        if not build:
            continue
        labels = ",".join(
            [f'proc="{_esc_label(proc["label"])}"'] +
            [f'{k}="{_esc_label(v)}"' for k, v in sorted(build.items())])
        smp.append(f"{_prom_name('build_info')}{{{labels}}} 1")
    lines = []
    for m, (typ, smp) in families.items():
        if not smp:
            continue
        lines.append(f"# TYPE {m} {typ}")
        lines.extend(smp)
    return "\n".join(lines) + "\n"


def merged_chrome_trace(spool_dir: Optional[str] = None,
                        procs: Optional[Sequence[dict]] = None,
                        include_self: bool = True,
                        since_time: Optional[float] = None) -> dict:
    """One chrome-trace across the fleet: a lane (chrome ``pid``) per
    process, named by a ``process_name`` metadata event, every lane
    rebased onto the earliest wall stamp so parent/child timelines
    align.  ``since_time`` (unix seconds) keeps only events at/after
    it — the ``POST /admin/trace?secs=N`` capture window."""
    if procs is None:
        procs = read_spool(spool_dir)
        if include_self:
            procs = _merge_self(list(procs))
    lanes = []
    t0 = None
    for proc in procs:
        evs = [e for e in proc.get("events") or ()
               if e.get("time") is not None
               and (since_time is None or e["time"] >= since_time)]
        if not evs:
            continue
        lanes.append((proc, evs))
        first = evs[0].get("time")
        if t0 is None or first < t0:
            t0 = first
    out = []
    for proc, evs in lanes:
        pid = int(proc.get("pid") or 0)
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "ts": 0,
                    "args": {"name": str(proc["label"])}})
        for ev in evs:
            args = dict(ev.get("args") or {})
            if "step" in ev:
                args["step"] = ev["step"]
            if "parent" in ev:
                args["parent_span"] = ev["parent"]
            if "trace" in ev:
                args["trace"] = ev["trace"]
            if "remote_parent" in ev:
                args["remote_parent"] = ev["remote_parent"]
            args["proc"] = str(proc["label"])
            base = {
                "name": str(ev.get("name", "?")),
                "cat": str(ev.get("kind", "instant")),
                "pid": pid,
                "tid": int(ev.get("tid", 0)),
                "ts": max(0.0, (ev["time"] - t0) * 1e6),
            }
            if ev.get("kind") == "counter":
                val = args.get("value", args.get("delta", 0))
                out.append(dict(base, ph="C",
                                args={"value": float(val)}))
            elif "dur" in ev:
                out.append(dict(base, ph="X",
                                dur=float(ev["dur"]) * 1e6, args=args))
            else:
                out.append(dict(base, ph="i", s="t", args=args))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Distributed request assembly
# ---------------------------------------------------------------------------

def assemble_trace(procs: Sequence[dict], trace_id: str) -> dict:
    """The span tree of one distributed request across process lanes.

    Selection is two-phase: (1) every event stamped with ``trace_id``
    (the HTTP handler binds the adopted/minted id to its thread, so
    admission/enqueue events inherit it; generation schedulers stamp it
    into event args); (2) every event sharing a correlation id
    (``rid``/``sid``, singular or plural) with phase-1 events — the
    scheduler-thread dispatch/prefill/decode events that carry no
    thread-bound context.

    Connectivity is judged over the union of parent-span edges,
    cross-process ``remote_parent`` edges (the caller's ``X-Parent-
    Span``) and the correlation groups: ``connected`` means every
    selected event sits in ONE component — HTTP accept through
    admission, prefill, decode steps and finish hang together, even
    when the lanes come from different processes."""
    nodes: Dict[tuple, dict] = {}
    for proc in procs:
        pid = proc.get("pid", 0)
        for ev in proc.get("events") or ():
            args = ev.get("args") or {}
            if (ev.get("trace") == trace_id
                    or args.get("trace") == trace_id
                    or trace_id in (args.get("traces") or ())):
                nodes[(pid, ev.get("id"))] = ev
    # phase 2: pull in rid/sid-correlated scheduler events
    corr_ids = set()
    for ev in nodes.values():
        args = ev.get("args") or {}
        for k in ("rid", "sid"):
            if args.get(k) is not None:
                corr_ids.add((k, args[k]))
        for k, one in (("rids", "rid"), ("sids", "sid")):
            for v in args.get(k) or ():
                corr_ids.add((one, v))
    if corr_ids:
        for proc in procs:
            pid = proc.get("pid", 0)
            for ev in proc.get("events") or ():
                key = (pid, ev.get("id"))
                if key in nodes:
                    continue
                args = ev.get("args") or {}
                hit = any((k, args.get(k)) in corr_ids
                          for k in ("rid", "sid"))
                hit = hit or any(
                    (one, v) in corr_ids
                    for k, one in (("rids", "rid"), ("sids", "sid"))
                    for v in args.get(k) or ())
                if hit:
                    nodes[key] = ev
    # union-find connectivity
    parent = {k: k for k in nodes}

    def find(k):
        while parent[k] != k:
            parent[k] = parent[parent[k]]
            k = parent[k]
        return k

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    by_id: Dict[object, List[tuple]] = {}
    for (pid, eid) in nodes:
        by_id.setdefault(eid, []).append((pid, eid))
    groups: Dict[tuple, tuple] = {}
    for key, ev in nodes.items():
        pid = key[0]
        if "parent" in ev and (pid, ev["parent"]) in nodes:
            union(key, (pid, ev["parent"]))
        rp = ev.get("remote_parent")
        if rp is not None:
            try:
                rp = int(rp)
            except (TypeError, ValueError):
                rp = None
        if rp is not None:
            for other in by_id.get(rp, ()):
                if other[0] != pid:
                    union(key, other)
        args = ev.get("args") or {}
        pairs = [(k, args[k]) for k in ("rid", "sid")
                 if args.get(k) is not None]
        pairs += [(one, v)
                  for k, one in (("rids", "rid"), ("sids", "sid"))
                  for v in args.get(k) or ()]
        for pair in pairs:
            rep = groups.get(pair)
            if rep is None:
                groups[pair] = key
            else:
                union(key, rep)
        # same-trace events on one thread chain through the span tree
        # already; a same-trace event with NO resolvable link still
        # belongs to the request — tie it to the trace root group
        if ev.get("trace") == trace_id or args.get("trace") == trace_id:
            rep = groups.get(("__trace__", trace_id))
            if rep is None:
                groups[("__trace__", trace_id)] = key
            else:
                union(key, rep)
    components = len({find(k) for k in nodes})
    return {
        "trace": trace_id,
        "events": len(nodes),
        "pids": sorted({k[0] for k in nodes}),
        "names": sorted({str(ev.get("name")) for ev in nodes.values()}),
        "components": components,
        "connected": bool(nodes) and components == 1,
    }


# ---------------------------------------------------------------------------
# Fleet flight bundle
# ---------------------------------------------------------------------------

def collect_fleet_bundle(dest_dir: str,
                         spool_dir: Optional[str] = None,
                         extra_paths: Sequence[str] = (),
                         reason: str = "incident",
                         extra: Optional[dict] = None) -> str:
    """Collect every process's black box into ``dest_dir``: spool dirs
    copied verbatim, ``extra_paths`` (kill-time flight dumps, give-up
    dumps) copied beside them, plus the merged chrome-trace, fleet
    snapshot and a manifest.  The parent's own exporter is flushed
    first so its lane is current.  Supervisor give-up and registry
    incidents call this; it must never raise into the caller's
    failure path (best-effort per item, manifest records what
    landed)."""
    spool_dir = spool_dir or flags.get_flag("obs_spool_dir")
    os.makedirs(dest_dir, exist_ok=True)
    exp = obs_hook._export
    if exp is not None:
        exp.flush()
    manifest = {"reason": reason, "time": time.time(),
                "pid": os.getpid(), "spool_dir": spool_dir,
                "collected": [], "errors": []}
    if extra:
        manifest["extra"] = extra
    procs = read_spool(spool_dir)
    for proc in procs:
        try:
            shutil.copytree(proc["dir"],
                            os.path.join(dest_dir, proc["label"]),
                            dirs_exist_ok=True)
            manifest["collected"].append(proc["label"])
        except Exception as e:
            manifest["errors"].append(f"{proc['label']}: {e}")
    for p in extra_paths:
        try:
            if os.path.isfile(p):
                shutil.copy2(p, os.path.join(dest_dir,
                                             os.path.basename(p)))
                manifest["collected"].append(os.path.basename(p))
        except Exception as e:
            manifest["errors"].append(f"{p}: {e}")
    procs = _merge_self(list(procs))
    try:
        with open(os.path.join(dest_dir, "merged_trace.json"), "w") as f:
            json.dump(merged_chrome_trace(procs=procs), f)
    except Exception as e:
        manifest["errors"].append(f"merged_trace: {e}")
    try:
        with open(os.path.join(dest_dir, "fleet_snapshot.json"),
                  "w") as f:
            json.dump(fleet_snapshot(procs=procs), f, default=str)
    except Exception as e:
        manifest["errors"].append(f"fleet_snapshot: {e}")
    from ..utils.checkpoint import write_atomic
    write_atomic(os.path.join(dest_dir, "bundle.json"),
                 json.dumps(manifest, default=str).encode())
    return dest_dir


# ---------------------------------------------------------------------------
# Live registry-plane aggregation (GET /admin/fleet)
# ---------------------------------------------------------------------------

class FleetView:
    """Aggregated per-replica readiness/SLO/inflight for the control
    plane.  Register :class:`~..serving.registry.ReplicaSet`s
    (their supervisors carry readiness and health URLs) or bare replica
    URLs; :meth:`snapshot` scrapes each replica's ``/healthz`` and
    ``/metrics`` (JSON) and returns the merged view ``GET /admin/fleet``
    serves.  Scrapes are best-effort with a short timeout — a dead
    replica reports ``reachable: false``, it never stalls the admin
    plane."""

    def __init__(self, timeout_s: float = 2.0):
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._targets: Dict[str, dict] = {}

    def register(self, name: str, replica_set=None,
                 urls: Sequence[str] = ()) -> None:
        with self._lock:
            self._targets[name] = {"replica_set": replica_set,
                                   "urls": list(urls)}

    def unregister(self, name: str) -> None:
        with self._lock:
            self._targets.pop(name, None)

    def _scrape(self, base_url: str) -> dict:
        import http.client
        from urllib.parse import urlparse
        u = urlparse(base_url)
        out: dict = {"reachable": False}
        conn = http.client.HTTPConnection(
            u.hostname or "127.0.0.1", u.port or 80,
            timeout=self.timeout_s)
        try:
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            body = json.loads(r.read() or b"{}")
            out["reachable"] = True
            out["ready"] = bool(r.status == 200)
            out["status"] = body.get("status")
            out["weights_version"] = body.get("weights_version")
            if "slo" in body:
                out["slo"] = body["slo"]
            conn.request("GET", "/metrics",
                         headers={"Accept": "application/json"})
            r = conn.getresponse()
            stats = json.loads(r.read() or b"{}")
            out["inflight"] = {}
            reg = stats.get("registry") or {}
            for k, v in (reg.get("inflight") or {}).items():
                out["inflight"][k] = v
            for key in ("queue_depth", "requests", "weights_version"):
                if isinstance(stats.get(key), (int, float)):
                    out.setdefault(key, stats[key])
            gen = stats.get("generation") or {}
            if gen:
                out["decode"] = {
                    k: gen[k] for k in ("active", "queue_depth", "state")
                    if k in gen}
        except (OSError, ValueError, http.client.HTTPException):
            pass
        finally:
            conn.close()
        return out

    def snapshot(self) -> dict:
        with self._lock:
            targets = {n: dict(t) for n, t in self._targets.items()}
        fleet = {}
        for name, target in targets.items():
            replicas: List[dict] = []
            rs = target.get("replica_set")
            if rs is not None:
                for info in rs.describe().get("replicas", ()):
                    entry = dict(info)
                    url = entry.get("url")
                    if url:
                        scraped = self._scrape(url)
                        # the supervisor's own readiness verdict wins
                        # over a scrape that raced a restart
                        scraped.update(
                            {k: v for k, v in entry.items()
                             if v is not None})
                        entry = scraped
                    replicas.append(entry)
            for url in target.get("urls") or ():
                replicas.append(dict({"url": url}, **self._scrape(url)))
            fleet[name] = {
                "replicas": replicas,
                "count": len(replicas),
                "ready": sum(1 for r in replicas if r.get("ready")),
            }
        out = {"time": time.time(), "fleet": fleet}
        spool = flags.get_flag("obs_spool_dir")
        if spool:
            snap = fleet_snapshot(spool, include_self=False)
            out["spool"] = {"procs": sorted(snap["procs"]),
                            "build_skew": snap["build_skew"]}
        return out
