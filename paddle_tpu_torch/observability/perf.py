"""Runtime performance observatory: step anatomy, memory, drift (the
counterpart of ``paddle_tpu/observability/perf.py``).

- **Step-time anatomy** — the static Executor reports each step's host
  time (feed conversion + dispatch) and, on every ``sample_every``-th
  step of a build identity, its *device* time: the site asks
  :meth:`PerfObservatory.begin` before dispatch, which on a sampled
  step of a CUDA program records a start event on the device's current
  stream, and :meth:`PerfObservatory.step` records the end event after
  dispatch and waits for it (``step.host_ms`` / ``step.device_ms``
  histograms, ``perf`` tracer lanes).  An unsampled step, and the
  disabled path, add no host synchronisation: no event is made, read
  or waited for.  A CPU program's device lane is the host wall from
  dispatch to return (CPU ops are synchronous).
- **Serving anatomy** — the engines report each dispatch / decode
  step's host wall (already host-synced by the engine) through
  :meth:`PerfObservatory.serving_step`; an ``InferenceEngine``
  dispatch that :meth:`PerfObservatory.serving_begin` samples also
  carries its device time by CUDA events (start before the predictor
  runs, end before the host read, read after the engine's own host
  read, so the sample adds no wait of its own).
- **Device-memory telemetry** — on sampled steps the caching
  allocator's live bytes are read per card (:func:`device_memory`),
  exported as ``mem.device.<card>.live_bytes`` /
  ``.peak_live_bytes`` gauges and compared against the compile
  record's predicted peak.
- **Drift tracker** — per build identity, a rolling window of measured
  step times and peak bytes against the cost model's prediction
  (``static/analysis/cost.py``, priced on ``CHIP_SPECS`` through
  ``resolve_perf_chip``); :func:`perf_report` renders totals, drift %%
  and the worst offenders.

Disabled-path contract: when the observatory is off, every
instrumented site pays ONE module-attribute None-check
(``core.obs_hook._perf``) — no imports, no calls, no timestamps.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from ..core import flags, obs_hook
from ..utils import monitor

__all__ = ["PerfObservatory", "enable_perf", "disable_perf",
           "perf_enabled", "get_perf", "perf_report",
           "render_perf_report", "device_memory"]

_DEVICE_SAMPLES = 128       # rolling window of fenced samples kept
_MAX_IDENTITIES = 256       # LRU cap on tracked compile identities —
                            # the Executor evicts stale-version cache
                            # entries but their identities would
                            # otherwise accumulate here forever


def device_memory() -> Dict[str, dict]:
    """Live bytes per card from the caching allocator.

    Returns ``{"cuda:<i>": {"live_bytes", "arrays", "reserved_bytes",
    "peak_bytes"}}`` (plus ``free_bytes`` / ``total_bytes`` from
    ``torch.cuda.mem_get_info`` for a card the process holds memory
    on) for every card, without initializing CUDA: before the process
    touches a card, and on a machine without one, it returns ``{}``
    (paddle_tpu's CPU backend sizes its live arrays instead; ROADMAP
    §C keeps the difference).  ``live_bytes`` is
    ``torch.cuda.memory_allocated``; ``arrays`` the allocator's live
    allocation count."""
    import torch
    per: Dict[str, dict] = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return per
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        slot = {"live_bytes": int(st.get("allocated_bytes.all.current", 0)),
                "arrays": int(st.get("allocation.all.current", 0)),
                "reserved_bytes": int(st.get("reserved_bytes.all.current",
                                             0)),
                "peak_bytes": int(st.get("allocated_bytes.all.peak", 0))}
        if slot["reserved_bytes"]:
            free, total = torch.cuda.mem_get_info(i)
            slot["free_bytes"], slot["total_bytes"] = int(free), int(total)
        per[f"cuda:{i}"] = slot
    return per


def _device_event(device):
    """A started timing event on ``device``'s current stream, or None
    for a device that is not a card (its ops return finished)."""
    if device is None or getattr(device, "type", device) != "cuda":
        return None
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Sample:
    """One sampled step's device lane: the start event (None off a
    card, whose ops return finished), and the end event :meth:`stop`
    records after the work was queued."""

    __slots__ = ("start", "end", "device")

    def __init__(self, start, device):
        self.start = start
        self.end = None
        self.device = device

    def stop(self) -> None:
        if self.start is not None and self.end is None:
            import torch
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record(torch.cuda.current_stream(self.device))

    def device_s(self, wait: bool) -> Optional[float]:
        """Seconds between the events (waiting for the end event when
        ``wait``; else the caller has already synchronized)."""
        if self.start is None:
            return None
        self.stop()
        if wait:
            self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def _comm_split_s(predicted: Optional[dict], measured_s: Optional[float]
                  ) -> Optional[dict]:
    """Exposed-vs-hidden comm split of one step, in seconds, from the
    compile record's overlap prediction plus (when available) a fenced
    measurement.

    ``overlap == 'none'`` is structural: the lowering barriers the comm
    stage after backward, so exposed == total and hidden == 0 by
    construction, never by measurement.  On an overlapping path the
    exposed share is *learned* from the fence: whatever the measured
    step ran beyond the compute-only prediction is attributed to
    exposed comm, clamped to [0, total comm] — an upper bound (queue
    backlog and model error land in it too, which is exactly what
    drift tracking wants to catch: a scheduling regression shows up as
    exposed comm growing toward total).  Without a measurement the
    predicted split is reported."""
    if not predicted:
        return None
    comm_s = predicted.get("predicted_comm_s")
    if not comm_s:
        return None
    path = predicted.get("comm_overlap", "none")
    exposed_pred = predicted.get("predicted_exposed_comm_s", comm_s)
    if path == "none":
        exposed = comm_s
    elif measured_s is not None:
        compute_s = max(0.0, (predicted.get("predicted_step_s") or 0.0)
                        - exposed_pred)
        exposed = min(comm_s, max(0.0, measured_s - compute_s))
    else:
        exposed = min(comm_s, exposed_pred)
    return {"comm_s": comm_s, "exposed_s": exposed,
            "hidden_s": comm_s - exposed, "overlap": path,
            "predicted_exposed_s": exposed_pred}


def _predicted_step_s(predicted: Optional[dict]) -> Optional[float]:
    """Predicted step seconds for a compile record's ``predicted``
    dict: taken verbatim when the record carries ``predicted_step_s``,
    re-derived from FLOPs / min traffic against the roofline chip spec
    (``FLAGS_perf_chip``, auto-detected backend by default) otherwise."""
    if not predicted:
        return None
    if predicted.get("predicted_step_s"):
        return float(predicted["predicted_step_s"])
    flops = predicted.get("flops")
    traffic = predicted.get("min_traffic_bytes")
    if not flops and not traffic:
        return None
    from ..static.analysis.cost import CHIP_SPECS, resolve_perf_chip
    spec = CHIP_SPECS.get(resolve_perf_chip())
    if spec is None:
        return None
    return max((flops or 0) / spec.peak_flops,
               (traffic or 0) / spec.hbm_bw)


class _IdentityPerf:
    """Rolling measured-vs-predicted state for one compile identity."""

    __slots__ = ("component", "identity", "steps", "sampled",
                 "host_sum_s", "device_s", "peak_bytes", "predicted")

    def __init__(self, component: str, identity):
        self.component = component
        self.identity = identity
        self.steps = 0
        self.sampled = 0
        self.host_sum_s = 0.0
        self.device_s: collections.deque = collections.deque(
            maxlen=_DEVICE_SAMPLES)
        self.peak_bytes = 0
        self.predicted: Optional[dict] = None

    def drift(self) -> dict:
        """Measured vs predicted, as the report shows it.  Drift %% is
        ``(measured - predicted) / predicted * 100`` — positive =
        slower / bigger than the model predicted.  ``peak_bytes`` is
        the max per-card live bytes observed at THIS identity's
        samples — the allocator's count is process-wide, so with several
        programs or engines resident the number is an upper bound on
        this identity's own footprint, not an attribution."""
        out: dict = {
            "component": self.component,
            "identity": self.identity,
            "steps": self.steps,
            "sampled": self.sampled,
            "host_ms_mean": (self.host_sum_s / self.steps * 1e3
                             if self.steps else None),
        }
        measured: dict = {}
        if self.device_s:
            srt = sorted(self.device_s)
            measured["step_ms_p50"] = srt[len(srt) // 2] * 1e3
            measured["step_ms_min"] = srt[0] * 1e3
            measured["step_ms_max"] = srt[-1] * 1e3
        if self.peak_bytes:
            measured["peak_bytes"] = self.peak_bytes
        out["measured"] = measured
        out["predicted"] = dict(self.predicted) if self.predicted else None
        drift: dict = {}
        pstep = _predicted_step_s(self.predicted)
        if pstep and measured.get("step_ms_p50"):
            drift["step_time_pct"] = (
                (measured["step_ms_p50"] / 1e3 - pstep) / pstep * 100.0)
            out["predicted_step_ms"] = pstep * 1e3
        ppeak = (self.predicted or {}).get("peak_bytes_per_shard") \
            or (self.predicted or {}).get("peak_bytes")
        if ppeak and self.peak_bytes:
            drift["peak_bytes_pct"] = (
                (self.peak_bytes - ppeak) / ppeak * 100.0)
        out["drift"] = drift
        split = _comm_split_s(
            self.predicted,
            (measured["step_ms_p50"] / 1e3
             if measured.get("step_ms_p50") is not None else None))
        if split is not None:
            out["comm"] = {
                "overlap": split["overlap"],
                "comm_ms": split["comm_s"] * 1e3,
                "exposed_ms": split["exposed_s"] * 1e3,
                "hidden_ms": split["hidden_s"] * 1e3,
                "predicted_exposed_ms":
                    split["predicted_exposed_s"] * 1e3,
            }
        return out


class PerfObservatory:
    """Process-wide runtime performance observatory.

    Install with :func:`enable_perf`; instrumented sites reach it
    through ``core.obs_hook._perf`` (one None-check when off).

    Args:
        sample_every: sample the device lane and memory every Nth step
            per build identity and per engine (default
            ``FLAGS_perf_sample_every``).  ``<= 0`` disables sampling —
            host anatomy only.
        memory: take device-memory samples on sampled steps.
    """

    def __init__(self, sample_every: Optional[int] = None,
                 memory: bool = True):
        self.sample_every = int(
            flags.get_flag("perf_sample_every") if sample_every is None
            else sample_every)
        self.memory = bool(memory)
        # reentrant: dump_flight embeds report() from the SIGTERM
        # handler, which can interrupt the SAME thread mid-step()
        # inside this lock — a plain Lock would self-deadlock the
        # crash path whose whole purpose is reliability at preemption
        self._lock = threading.RLock()
        self._ids: "collections.OrderedDict[tuple, _IdentityPerf]" = \
            collections.OrderedDict()
        self._ids_evicted = 0
        self._dev_peak: Dict[str, int] = {}
        self._serving_steps: Dict[tuple, int] = {}
        self._serving: Dict[tuple, dict] = {}

    # -- executor step anatomy --------------------------------------------
    def _identity(self, component: str, identity) -> _IdentityPerf:
        key = (component, identity)
        idp = self._ids.get(key)
        if idp is None:
            idp = self._ids[key] = _IdentityPerf(component, identity)
            if len(self._ids) > _MAX_IDENTITIES:
                self._ids.popitem(last=False)   # least recent
                self._ids_evicted += 1
        else:
            self._ids.move_to_end(key)
        return idp

    def begin(self, component: str, identity, device) -> Optional[_Sample]:
        """Before dispatch: the sample of the coming step of
        ``identity`` when it is a sampled one, else None (nothing
        recorded, nothing to wait for).  This is the one place the
        sampling decision is made; on a card the sample's start event
        is recorded here, on any other device it has none."""
        if self.sample_every <= 0:
            return None
        with self._lock:
            idp = self._ids.get((component, identity))
            n = (idp.steps if idp is not None else 0) + 1
        if n % self.sample_every:
            return None
        return _Sample(_device_event(device), device)

    def step(self, component: str, identity, t_feed0: float,
             host_feed_s: float, t_disp0: float, dispatch_s: float,
             predicted: Optional[dict] = None,
             sample: Optional[_Sample] = None) -> None:
        """One executor step.  ``t_feed0``/``t_disp0`` are the
        perf_counter stamps at feed-conversion and dispatch start;
        ``sample`` is :meth:`begin`'s answer for this step: a step with
        a sample is a sampled one.  On a card its end event is recorded
        and waited for (the one host synchronisation the observatory
        adds); on any other step nothing touches the device."""
        with self._lock:
            idp = self._identity(component, identity)
            idp.steps += 1
            n = idp.steps
            host_s = host_feed_s + dispatch_s
            idp.host_sum_s += host_s
            if predicted is not None:
                idp.predicted = predicted
            fence = sample is not None
            if fence:
                idp.sampled += 1
        monitor.stat_observe("step.host_ms", host_s * 1e3)
        trc = obs_hook._tracer
        if trc is not None:
            # host lanes as two truthful intervals: feed conversion
            # and dispatch are separated by cache-lookup/state work
            trc.emit("perf", "step.host.feed", ts=t_feed0,
                     dur=host_feed_s, args={"identity": str(identity)})
            trc.emit("perf", "step.host.dispatch", ts=t_disp0,
                     dur=dispatch_s, args={"identity": str(identity)})
        if not fence:
            return
        device_s = sample.device_s(wait=True)
        if device_s is None:        # a CPU program: its ops returned done
            device_s = time.perf_counter() - t_disp0
        with self._lock:
            idp.device_s.append(device_s)
        monitor.stat_observe("step.device_ms", device_s * 1e3)
        monitor.stat_add("perf.fences")
        split = _comm_split_s(idp.predicted, device_s)
        if split is not None:
            monitor.stat_observe("comm.exposed_ms",
                                 split["exposed_s"] * 1e3)
            monitor.stat_observe("comm.hidden_ms",
                                 split["hidden_s"] * 1e3)
        if trc is not None:
            trc.emit("perf", "step.device", ts=t_disp0, dur=device_s,
                     args={"identity": str(identity), "step": n})
        if self.memory:
            self._sample_memory(idp)

    # -- serving anatomy ---------------------------------------------------
    def serving_begin(self, engine: Optional[str], kind: str,
                      device) -> Optional[_Sample]:
        """Before an engine's dispatch: a started device sample when
        the coming step of ``(engine, kind)`` is a sampled one and
        ``device`` is a card, else None."""
        if self.sample_every <= 0:
            return None
        with self._lock:
            n = self._serving_steps.get((engine, kind), 0) + 1
        if n % self.sample_every:
            return None
        ev = _device_event(device)
        return None if ev is None else _Sample(ev, device)

    def serving_step(self, engine: Optional[str], kind: str,
                     dur_s: float, sample: Optional[_Sample] = None
                     ) -> None:
        """One serving dispatch / decode step (already host-synced by
        the engine).  ``engine`` is the engine's ``name`` — None when
        unnamed.  Feeds the process-wide step histogram, mirrored per
        named engine (``perf.serving.<engine>.<kind>_ms``), the
        per-engine anatomy of :meth:`report`, and the memory sampler on
        the observatory cadence.  ``sample`` (from
        :meth:`serving_begin`, its end recorded before the engine's
        host read) adds the device lane
        (``perf.serving.<kind>_device_ms``) without a wait of its
        own."""
        monitor.stat_observe(f"perf.serving.{kind}_ms", dur_s * 1e3)
        if engine:
            monitor.stat_observe(f"perf.serving.{engine}.{kind}_ms",
                                 dur_s * 1e3)
        device_s = sample.device_s(wait=False) if sample is not None \
            else None
        if device_s is not None:
            monitor.stat_observe(f"perf.serving.{kind}_device_ms",
                                 device_s * 1e3)
            if engine:
                monitor.stat_observe(
                    f"perf.serving.{engine}.{kind}_device_ms",
                    device_s * 1e3)
        with self._lock:
            # cadence per (engine, kind): an unnamed InferenceEngine
            # and unnamed GenerationEngine both pass engine=None
            ck = (engine, kind)
            n = self._serving_steps.get(ck, 0) + 1
            self._serving_steps[ck] = n
            an = self._serving.get(ck)
            if an is None:
                an = self._serving[ck] = {
                    "steps": 0, "sampled": 0,
                    "host_ms": collections.deque(maxlen=_DEVICE_SAMPLES),
                    "device_ms": collections.deque(
                        maxlen=_DEVICE_SAMPLES)}
            an["steps"] += 1
            an["host_ms"].append(dur_s * 1e3)
            if device_s is not None:
                an["sampled"] += 1
                an["device_ms"].append(device_s * 1e3)
        trc = obs_hook._tracer
        if trc is not None and device_s is not None:
            trc.emit("perf", f"serving.{kind}.device",
                     args={"engine": engine, "device_ms": device_s * 1e3})
        if self.memory and self.sample_every > 0 \
                and n % self.sample_every == 0:
            self._sample_memory(None)

    # -- device memory -----------------------------------------------------
    def _sample_memory(self, idp: Optional[_IdentityPerf]) -> None:
        per = device_memory()
        total = 0
        peak_dev = 0
        with self._lock:
            for key, slot in per.items():
                b = slot["live_bytes"]
                total += b
                peak_dev = max(peak_dev, b)
                prev = self._dev_peak.get(key, 0)
                if b > prev:
                    self._dev_peak[key] = b
                monitor.stat_set(f"mem.device.{key}.live_bytes", b)
                monitor.stat_set(f"mem.device.{key}.peak_live_bytes",
                                 max(b, prev))
            if idp is not None and peak_dev > idp.peak_bytes:
                idp.peak_bytes = peak_dev
        monitor.stat_set("mem.live_bytes_total", total)
        trc = obs_hook._tracer
        if trc is not None:
            trc.counter("mem.live_bytes_total", 0, value=total)

    def memory_snapshot(self) -> dict:
        """Current + peak live bytes per device label."""
        per = device_memory()
        with self._lock:
            peaks = dict(self._dev_peak)
        return {key: {"live_bytes": slot["live_bytes"],
                      "arrays": slot["arrays"],
                      "peak_live_bytes": max(peaks.get(key, 0),
                                             slot["live_bytes"])}
                for key, slot in per.items()}

    # -- reporting ---------------------------------------------------------
    def report(self) -> dict:
        """The drift report: totals, per-identity measured-vs-predicted
        drift %%, worst offenders first (``explain_compiles``-style)."""
        with self._lock:
            ids = [idp.drift() for idp in self._ids.values()]
            peaks = dict(self._dev_peak)
            serving = {f"{e or '-'}.{k}": _anatomy(an)
                       for (e, k), an in self._serving.items()}
        ids.sort(key=lambda r: abs(r["drift"].get("step_time_pct", 0.0)),
                 reverse=True)
        return {
            "enabled": True,
            "sample_every": self.sample_every,
            "totals": {
                "identities": len(ids),
                "identities_evicted": self._ids_evicted,
                "steps": sum(r["steps"] for r in ids),
                "sampled": sum(r["sampled"] for r in ids),
            },
            "identities": ids,
            "worst": [f"{r['component']}#{r['identity']}" for r in ids
                      if r["drift"].get("step_time_pct") is not None][:5],
            "devices": {k: {"peak_live_bytes": v}
                        for k, v in peaks.items()},
            "serving": serving,
        }


def _p50(xs) -> Optional[float]:
    if not xs:
        return None
    srt = sorted(xs)
    return srt[len(srt) // 2]


def _anatomy(an: dict) -> dict:
    """One engine step kind's anatomy as :meth:`PerfObservatory.report`
    shows it: steps, sampled steps, host ms p50 over the recent window
    and device ms (CUDA events) p50, min and max over the samples."""
    dev = list(an["device_ms"])
    return {"steps": an["steps"], "sampled": an["sampled"],
            "host_ms_p50": _p50(an["host_ms"]),
            "device_ms_p50": _p50(dev),
            "device_ms_min": min(dev) if dev else None,
            "device_ms_max": max(dev) if dev else None}


def enable_perf(sample_every: Optional[int] = None,
                memory: bool = True) -> PerfObservatory:
    """Install (and return) a fresh process-wide observatory."""
    p = PerfObservatory(sample_every=sample_every, memory=memory)
    obs_hook.set_perf(p)
    return p


def disable_perf() -> None:
    """Remove the observatory; instrumented sites return to the one
    None-check disabled path."""
    obs_hook.set_perf(None)


def perf_enabled() -> bool:
    return obs_hook._perf is not None


def get_perf() -> Optional[PerfObservatory]:
    return obs_hook._perf


def perf_report() -> dict:
    """The installed observatory's drift report (``{"enabled": False}``
    when the observatory is off)."""
    p = obs_hook._perf
    if p is None:
        return {"enabled": False}
    return p.report()


def _fmt_pct(v) -> str:
    return "n/a" if v is None else f"{v:+.1f}%"


def render_perf_report(rep: Optional[dict] = None) -> str:
    """Human-readable drift report (the CLI's output)."""
    rep = perf_report() if rep is None else rep
    if not rep.get("enabled"):
        return "perf observatory: disabled (observability.enable_perf())"
    t = rep["totals"]
    lines = [
        f"perf observatory: {t['identities']} compile identities, "
        f"{t['steps']} steps, {t['sampled']} fenced samples "
        f"(every {rep['sample_every']})"]
    for r in rep["identities"]:
        m = r["measured"]
        d = r["drift"]
        lines.append(
            f"  {r['component']}#{r['identity']}: steps={r['steps']} "
            f"host {r['host_ms_mean']:.3f} ms/step" if r["host_ms_mean"]
            is not None else
            f"  {r['component']}#{r['identity']}: steps={r['steps']}")
        if m.get("step_ms_p50") is not None:
            pred = (f", predicted {r['predicted_step_ms']:.3f} ms "
                    f"(drift {_fmt_pct(d.get('step_time_pct'))})"
                    if r.get("predicted_step_ms") else "")
            lines.append(
                f"    device p50 {m['step_ms_p50']:.3f} ms "
                f"[{m['step_ms_min']:.3f}, {m['step_ms_max']:.3f}]{pred}")
        if m.get("peak_bytes"):
            p = r.get("predicted") or {}
            ppeak = p.get("peak_bytes_per_shard") or p.get("peak_bytes")
            pred = (f", predicted {ppeak} "
                    f"(drift {_fmt_pct(d.get('peak_bytes_pct'))})"
                    if ppeak else "")
            lines.append(f"    peak live bytes {m['peak_bytes']}{pred}")
        c = r.get("comm")
        if c is not None:
            lines.append(
                f"    comm {c['comm_ms']:.3f} ms "
                f"(exposed {c['exposed_ms']:.3f} / hidden "
                f"{c['hidden_ms']:.3f}, overlap={c['overlap']}, "
                f"predicted exposed {c['predicted_exposed_ms']:.3f})")
    for name, an in sorted(rep.get("serving", {}).items()):
        dev = (f", device p50 {an['device_ms_p50']:.3f} ms over "
               f"{an['sampled']} samples"
               if an.get("device_ms_p50") is not None else "")
        lines.append(f"  serving {name}: steps={an['steps']} host p50 "
                     f"{an['host_ms_p50']:.3f} ms{dev}")
    for dev, slot in sorted(rep.get("devices", {}).items()):
        lines.append(f"  device {dev}: peak live "
                     f"{slot['peak_live_bytes']} bytes")
    if rep.get("worst"):
        lines.append(f"  worst step-time drift: "
                     f"{', '.join(rep['worst'])}")
    return "\n".join(lines)
