"""Multi-model serving control plane: registry, weighted fair queuing
and quotas (the counterpart of ``paddle_tpu/serving/registry.py``).

- :class:`ModelRegistry` — load/unload/alias models at runtime.  Each
  model owns its own :class:`~.engine.InferenceEngine` and/or
  :class:`~.generation.GenerationEngine` (its own queue, dispatcher and
  pages).  Requests route by model name or alias; an unknown name
  raises :class:`UnknownModel` (HTTP 404).  Lifecycle: ``loading ->
  warming -> ready -> draining -> unloaded``; unload removes the name
  from routing first, then drains through the engines' ``drain()`` /
  ``close()`` contracts.
- **Weighted fair queuing**: admission shares one ``max_inflight``
  pool.  While the pool has headroom every model admits freely; once
  it is saturated a model is clamped to its weighted share
  ``max_inflight * w / sum(w)``.
- **Per-tenant quotas**: token buckets (``rate`` req/s, ``burst``)
  keyed by tenant id, checked before the engine queue
  (:class:`QuotaExceeded`, HTTP 429).
- :class:`ReplicaSet` — N supervised replicas of one serving entry,
  scaled at runtime.
- :class:`ElasticityController` — the SLO burn-rate rules
  (:mod:`..observability.slo`) evaluated per model over the per-engine
  monitor mirrors drive replica counts through a ``scaler`` callback;
  a model still burning at ``max_replicas`` is shed (``QueueFull``)
  until its windows clear.  Observable through ``elasticity.*`` stats
  and tracer events.
- ``load(weights_dir=...)`` runs a per-model :class:`~.hotswap.
  WeightWatcher` on that snapshot directory.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..core import flags, obs_hook
from ..utils import monitor
from .engine import EngineClosed, InferenceEngine, QueueFull, ServingError

__all__ = ["ModelRegistry", "ModelEntry", "UnknownModel", "QuotaExceeded",
           "ElasticityController", "ReplicaSet"]


class UnknownModel(ServingError):
    """Request routed to a model name/alias the registry does not hold
    (HTTP: a clean 404, never a 500)."""


class QuotaExceeded(ServingError):
    """A tenant exhausted its token bucket (HTTP 429 + Retry-After)."""


def _emit(event: str, **args) -> None:
    trc = obs_hook._tracer
    if trc is not None:
        trc.emit("registry", event, args=args)


class _TokenBucket:
    """Classic token bucket; ``admit`` is called under the registry
    lock, so no internal locking."""

    __slots__ = ("rate", "burst", "tokens", "t")

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst < 1:
            raise ValueError("quota needs rate > 0 and burst >= 1")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t = time.monotonic()

    def admit(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after_s(self) -> float:
        return max(0.0, (1.0 - self.tokens) / self.rate)


class ModelEntry:
    """One registered model: its engines, watcher, routing weight and
    lifecycle state.  Mutated only under the registry lock (state/
    weight/shedding); the engines themselves are internally threadsafe."""

    STATES = ("loading", "warming", "ready", "draining", "unloaded",
              "failed")

    def __init__(self, name: str, *, engine: Optional[InferenceEngine]
                 = None, generation=None, watcher=None,
                 weight: float = 1.0, artifact: Optional[str] = None,
                 state: str = "loading"):
        if engine is None and generation is None:
            raise ValueError(f"model {name!r} needs an InferenceEngine, "
                             f"a GenerationEngine, or both")
        if weight <= 0:
            raise ValueError("weight must be > 0")
        self.name = name
        self.engine = engine
        self.generation = generation
        self.watcher = watcher
        self.weight = float(weight)
        self.artifact = artifact
        self.state = state
        self.shedding = False           # shed decision (an elasticity
                                        # controller sets it)
        self.created = time.time()

    @property
    def weights_version(self) -> int:
        for src in (self.engine, self.generation):
            if src is not None:
                return int(getattr(src, "weights_version", 0))
        return 0

    def describe(self, inflight: int = 0) -> dict:
        d = {"state": self.state, "weight": self.weight,
             "weights_version": self.weights_version,
             "inflight": inflight, "shedding": self.shedding,
             "engines": [k for k, v in (("inference", self.engine),
                                        ("generation", self.generation))
                         if v is not None]}
        if self.artifact:
            d["artifact"] = self.artifact
        if self.generation is not None:
            d["page_pool"] = self.generation.stats()["page_pool"]
        return d


class ModelRegistry:
    """Runtime-mutable model routing table + fair admission layer.

    Args:
        max_inflight: the WFQ pool — total in-flight requests across
            all models before weighted shares clamp admission.  None
            disables WFQ (each engine still has its own bounded queue).
        default_model: name served when a request carries no model
            (single-model clients keep working unchanged); defaults to
            the first registered model.
    """

    def __init__(self, *, max_inflight: Optional[int] = None,
                 default_model: Optional[str] = None):
        self._mu = threading.RLock()
        self._models: Dict[str, ModelEntry] = {}
        self._aliases: Dict[str, str] = {}
        self._quotas: Dict[str, _TokenBucket] = {}
        self._inflight: Dict[str, int] = {}
        self._max_inflight = (int(max_inflight)
                              if max_inflight is not None else None)
        self._default = default_model
        self._closed = False

    # -- registration / lifecycle ------------------------------------------
    def register(self, name: str, *, engine: Optional[InferenceEngine]
                 = None, generation=None, watcher=None,
                 weight: float = 1.0, aliases: Sequence[str] = (),
                 artifact: Optional[str] = None,
                 ready: bool = True) -> ModelEntry:
        """Attach pre-built engines under ``name``.  ``ready=False``
        registers the model routable-but-warming (requests answer 503
        through :class:`EngineClosed`) — call :meth:`mark_ready` after
        warmup, exactly like the HTTP readiness split."""
        entry = ModelEntry(name, engine=engine, generation=generation,
                           watcher=watcher, weight=weight,
                           artifact=artifact,
                           state="ready" if ready else "warming")
        with self._mu:
            if self._closed:
                raise EngineClosed("registry is closed")
            if name in self._models or name in self._aliases:
                raise ValueError(f"model name {name!r} already in use")
            self._models[name] = entry
            self._inflight[name] = 0
            for a in aliases:
                self._alias_locked(a, name)
            if self._default is None:
                self._default = name
            n = len(self._models)
        monitor.stat_add("registry.loads")
        monitor.stat_set("registry.models", n)
        _emit("register", model=name, ready=ready,
              aliases=list(aliases))
        return entry

    def load(self, name: str, artifact: str, *,
             weights_dir: Optional[str] = None,
             weights_poll_s: float = 2.0,
             aliases: Sequence[str] = (), weight: float = 1.0,
             warmup: bool = True,
             rest_shapes: Optional[Sequence[Sequence[int]]] = None,
             engine_kwargs: Optional[dict] = None) -> ModelEntry:
        """Load an inference artifact end to end: Predictor (on the
        device ``set_device`` chose, else the current CUDA device) ->
        engine (named ``name`` so its stats mirror per-model) -> warmup
        -> ready, with an optional per-model :class:`~.hotswap.
        WeightWatcher` polling ``weights_dir`` every ``weights_poll_s``
        seconds.  The name becomes routable only once ready — a load
        can never race traffic into a cold engine."""
        from .. import inference
        kw = dict(engine_kwargs or {})
        kw.setdefault("name", name)
        eng = InferenceEngine(
            inference.create_predictor(inference.Config(artifact)), **kw)
        entry = self.register(name, engine=eng, aliases=aliases,
                              weight=weight, artifact=artifact,
                              ready=False)
        try:
            if warmup:
                eng.warmup(rest_shapes=rest_shapes)
            if weights_dir:
                from .hotswap import WeightWatcher
                entry.watcher = WeightWatcher(
                    weights_dir, engine=eng, poll_s=weights_poll_s,
                    rest_shapes=rest_shapes).start()
        except BaseException:
            with self._mu:
                entry.state = "failed"
            eng.close()
            self._forget(name)
            raise
        self.mark_ready(name)
        return entry

    def mark_ready(self, name: str) -> None:
        with self._mu:
            entry = self._models.get(name)
            if entry is None:
                raise UnknownModel(f"unknown model {name!r}")
            entry.state = "ready"
        _emit("ready", model=name)

    def _alias_locked(self, alias: str, target: str) -> None:
        if target not in self._models:
            raise UnknownModel(f"alias target {target!r} is not a "
                               f"registered model")
        if alias in self._models:
            raise ValueError(f"alias {alias!r} shadows a model name")
        self._aliases[alias] = target

    def alias(self, alias: str, target: str) -> None:
        """Point ``alias`` at ``target`` (create or atomically flip —
        a canary rollout is ``alias("prod", "model-v2")``)."""
        with self._mu:
            self._alias_locked(alias, target)
        monitor.stat_add("registry.alias_flips")
        _emit("alias", alias=alias, target=target)

    def unalias(self, alias: str) -> None:
        with self._mu:
            if self._aliases.pop(alias, None) is None:
                raise UnknownModel(f"unknown alias {alias!r}")
        _emit("unalias", alias=alias)

    def _forget(self, name: str) -> None:
        with self._mu:
            self._models.pop(name, None)
            self._inflight.pop(name, None)
            for a in [a for a, t in self._aliases.items() if t == name]:
                del self._aliases[a]
            if self._default == name:
                self._default = next(iter(self._models), None)
            monitor.stat_set("registry.models", len(self._models))

    def unload(self, name: str, timeout: float = 30.0) -> dict:
        """Remove a model: routing first (new requests get
        :class:`UnknownModel` immediately), then drain + close its
        engines through their existing contracts — every accepted
        request finishes or fails cleanly, no future is stranded, and
        a generation engine's page pool is fully reclaimed before this
        returns.  The watcher stops before the drain so a hot swap can
        never land mid-teardown.  Returns a teardown summary (drained
        flags + final page-pool accounting)."""
        with self._mu:
            entry = self._models.get(name)
            if entry is None:
                raise UnknownModel(f"unknown model {name!r}")
            entry.state = "draining"
        _emit("unload_begin", model=name)
        if entry.watcher is not None:
            entry.watcher.stop()
        summary: dict = {"model": name}
        if entry.engine is not None:
            summary["engine_drained"] = entry.engine.drain(timeout=timeout)
            entry.engine.close()
        if entry.generation is not None:
            summary["generation_drained"] = entry.generation.drain(
                timeout=timeout)
            entry.generation.close()
            pool = entry.generation.stats()["page_pool"]
            summary["page_pool"] = pool
            summary["pages_reclaimed"] = pool["in_use"] == 0
        with self._mu:
            entry.state = "unloaded"
        self._forget(name)
        monitor.stat_add("registry.unloads")
        _emit("unload", model=name, **{k: v for k, v in summary.items()
                                       if k != "model"})
        return summary

    def close(self, timeout: float = 30.0) -> None:
        """Unload every model (drain + close) and refuse further use."""
        with self._mu:
            self._closed = True
            names = list(self._models)
        for n in names:
            try:
                self.unload(n, timeout=timeout)
            except UnknownModel:
                pass        # concurrent unload won the race

    # -- routing & admission -----------------------------------------------
    def resolve(self, model: Optional[str]) -> ModelEntry:
        """Name/alias -> live entry.  Unknown names raise
        :class:`UnknownModel`; a known-but-not-ready model raises
        :class:`EngineClosed` (503: retry, don't 404 — the name exists)."""
        with self._mu:
            name = model or self._default
            if name is None:
                raise UnknownModel("no models registered")
            name = self._aliases.get(name, name)
            entry = self._models.get(name)
            if entry is None:
                monitor.stat_add("registry.unknown_model")
                raise UnknownModel(f"unknown model {model!r}")
            if entry.state != "ready":
                raise EngineClosed(
                    f"model {name!r} is {entry.state}")
            return entry

    def set_quota(self, tenant: str, rate: float,
                  burst: Optional[float] = None) -> None:
        """Cap ``tenant`` at ``rate`` requests/second with a bucket of
        ``burst`` (default: ``max(rate, 1)``).  Tenants without a quota
        are unlimited."""
        with self._mu:
            self._quotas[str(tenant)] = _TokenBucket(
                rate, burst if burst is not None else max(rate, 1.0))

    def clear_quota(self, tenant: str) -> None:
        with self._mu:
            self._quotas.pop(str(tenant), None)

    def set_weight(self, name: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError("weight must be > 0")
        with self._mu:
            entry = self._models.get(name)
            if entry is None:
                raise UnknownModel(f"unknown model {name!r}")
            entry.weight = float(weight)

    def _admit_locked(self, entry: ModelEntry,
                      tenant: Optional[str]) -> None:
        """Quota then WFQ, both under the lock; raising here means the
        request never touched an engine queue."""
        if entry.shedding:
            monitor.stat_add("registry.elasticity_shed")
            raise QueueFull(
                f"model {entry.name!r} is shedding (SLO burn at max "
                f"replicas); retry later")
        if tenant is not None:
            b = self._quotas.get(str(tenant))
            if b is not None and not b.admit():
                monitor.stat_add("registry.quota_shed")
                _emit("quota_shed", model=entry.name, tenant=str(tenant))
                raise QuotaExceeded(
                    f"tenant {tenant!r} over quota ({b.rate:g} req/s, "
                    f"burst {b.burst:g}); retry in "
                    f"{b.retry_after_s():.2f}s")
        if self._max_inflight is not None:
            total = sum(self._inflight.values())
            if total >= self._max_inflight:
                # pool saturated: clamp this model to its weighted
                # share (work-conserving below saturation — the share
                # only binds under contention)
                w_total = sum(e.weight for e in self._models.values()
                              if e.state == "ready") or entry.weight
                share = self._max_inflight * entry.weight / w_total
                if self._inflight[entry.name] + 1 > share:
                    monitor.stat_add("registry.wfq_shed")
                    _emit("wfq_shed", model=entry.name,
                          inflight=self._inflight[entry.name],
                          share=share)
                    raise QueueFull(
                        f"model {entry.name!r} over its weighted fair "
                        f"share ({self._inflight[entry.name]}/"
                        f"{share:.1f} of pool {self._max_inflight})")
        self._inflight[entry.name] += 1
        monitor.stat_set(f"registry.inflight.{entry.name}",
                         self._inflight[entry.name])
        # emitted on the admitting (HTTP handler) thread, so it carries
        # the bound distributed trace id — the admission decision is a
        # node in the request's cross-process span tree
        _emit("admit", model=entry.name,
              tenant=None if tenant is None else str(tenant),
              inflight=self._inflight[entry.name])

    def _release(self, name: str) -> None:
        with self._mu:
            if name in self._inflight and self._inflight[name] > 0:
                self._inflight[name] -= 1
                monitor.stat_set(f"registry.inflight.{name}",
                                 self._inflight[name])

    def infer(self, model: Optional[str], inputs, *,
              tenant: Optional[str] = None,
              deadline_ms: Optional[float] = None):
        """Route one inference request; returns the engine Future.
        Admission order: resolve -> shed flag -> tenant quota -> WFQ
        share -> the engine's own queue (which may still shed
        ``QueueFull`` when ITS bounded queue is full)."""
        entry = self.resolve(model)
        if entry.engine is None:
            raise UnknownModel(
                f"model {entry.name!r} has no inference engine")
        with self._mu:
            self._admit_locked(entry, tenant)
        monitor.stat_add("registry.requests")
        try:
            fut = entry.engine.infer(inputs, deadline_ms=deadline_ms)
        except BaseException:
            self._release(entry.name)
            raise
        fut.add_done_callback(lambda _f: self._release(entry.name))
        return fut

    def infer_sync(self, model: Optional[str], inputs, *,
                   tenant: Optional[str] = None,
                   deadline_ms: Optional[float] = None,
                   timeout: Optional[float] = None):
        return self.infer(model, inputs, tenant=tenant,
                          deadline_ms=deadline_ms).result(timeout)

    def generate(self, model: Optional[str], prompt, *,
                 tenant: Optional[str] = None, **kw):
        """Route one generation request; returns the
        :class:`GenerationStream`.  Same admission ladder as
        :meth:`infer`; the WFQ slot is held until the stream finishes
        (generation is long-lived — that is exactly what the share
        must account for)."""
        entry = self.resolve(model)
        if entry.generation is None:
            raise UnknownModel(
                f"model {entry.name!r} has no generation engine")
        with self._mu:
            self._admit_locked(entry, tenant)
        monitor.stat_add("registry.requests")
        try:
            stream = entry.generation.generate(prompt, **kw)
        except BaseException:
            self._release(entry.name)
            raise
        stream.future.add_done_callback(
            lambda _f: self._release(entry.name))
        return stream

    # -- introspection ------------------------------------------------------
    @property
    def default_model(self) -> Optional[str]:
        with self._mu:
            return self._default

    def set_default(self, name: str) -> None:
        with self._mu:
            if self._aliases.get(name, name) not in self._models:
                raise UnknownModel(f"unknown model {name!r}")
            self._default = name

    def models(self) -> List[str]:
        with self._mu:
            return sorted(self._models)

    def describe(self) -> dict:
        """The ``GET /admin/models`` payload: every model's state,
        version, engines, inflight and weight, plus aliases and the
        default route."""
        with self._mu:
            return {
                "models": {n: e.describe(self._inflight.get(n, 0))
                           for n, e in self._models.items()},
                "aliases": dict(self._aliases),
                "default": self._default,
                "max_inflight": self._max_inflight,
                "quotas": {t: {"rate": b.rate, "burst": b.burst}
                           for t, b in self._quotas.items()},
            }

    def stats(self) -> dict:
        with self._mu:
            return {
                "models": len(self._models),
                "inflight": dict(self._inflight),
                "counters": {k: monitor.get_stat(f"registry.{k}")
                             for k in ("requests", "loads", "unloads",
                                       "alias_flips", "wfq_shed",
                                       "quota_shed", "unknown_model",
                                       "elasticity_shed")},
            }


class ReplicaSet:
    """N supervised replicas of one serving entry, scalable at runtime.

    Each replica is a supervisor object (``run()`` blocks while it
    keeps its child serving, ``stop()`` ends it; optional ``name``,
    ``ready``, ``exit_history`` and ``health_url`` feed
    :meth:`describe`) run on its own thread; ``scale_to(n)`` spawns or
    stops supervisors to match.  ``factory(index)`` must return an
    UNSTARTED supervisor — the set owns ``run()``/``stop()``:
    ``distributed.ServingSupervisor`` is one (a replica process, probed
    on its ``/healthz``, restarted when it crashes or hangs)."""

    def __init__(self, factory: Callable[[int], object],
                 name: str = "model"):
        self._factory = factory
        self.name = name
        self._mu = threading.Lock()
        self._replicas: List[tuple] = []    # (supervisor, thread)

    @property
    def count(self) -> int:
        with self._mu:
            return len(self._replicas)

    def scale_to(self, n: int) -> int:
        """Spawn/stop supervisors until ``count == n``; returns the new
        count.  Scale-down stops the newest replica first (oldest keeps
        the warmest cache)."""
        n = max(0, int(n))
        with self._mu:
            while len(self._replicas) < n:
                idx = len(self._replicas)
                sup = self._factory(idx)
                th = threading.Thread(
                    target=sup.run,
                    name=f"replica-{self.name}-{idx}", daemon=True)
                th.start()
                self._replicas.append((sup, th))
            while len(self._replicas) > n:
                sup, th = self._replicas.pop()
                sup.stop()
                th.join(timeout=10.0)
            return len(self._replicas)

    def stop(self) -> None:
        self.scale_to(0)

    def describe(self) -> dict:
        """Per-replica control-plane view: supervisor readiness, the
        replica's base URL (derived from its health probe URL) and its
        restart count — ``GET /admin/fleet`` merges this with a live
        scrape of each URL."""
        from urllib.parse import urlparse
        with self._mu:
            replicas = []
            for i, (sup, th) in enumerate(self._replicas):
                info = {
                    "index": i,
                    "supervisor": getattr(sup, "name", None),
                    "alive": th.is_alive(),
                    "ready": getattr(sup, "ready", None),
                    "restarts": len(getattr(sup, "exit_history", ())
                                    or ()),
                    "url": None,
                }
                hu = getattr(sup, "health_url", None)
                if hu:
                    u = urlparse(hu)
                    info["url"] = f"{u.scheme or 'http'}://{u.netloc}"
                replicas.append(info)
            return {"name": self.name, "count": len(replicas),
                    "replicas": replicas}


class ElasticityController:
    """SLO burn rates -> per-model replica counts and shed decisions.

    Per ready model, a rule set from ``rules_for(name)`` (default: p99
    latency against ``objective_ms`` over that model's per-engine
    mirror ``serving.engine.<name>.latency_ms``) is evaluated by its
    own :class:`~..observability.slo.SLOMonitor` each
    :meth:`poll`:

    - burn >= ``scale_up_burn`` for ``breach_polls`` consecutive polls
      scales the model up one replica (to ``max_replicas``) through
      ``scaler(name, desired)``, then holds through ``cooldown_s``;
    - burn <= ``scale_down_burn`` for ``clear_polls`` polls scales it
      down one (to ``min_replicas``);
    - still breaching at ``max_replicas``: the *shed decision* — the
      registry sheds that model's new requests (``QueueFull``) until
      the burn clears, protecting every other model's objectives.

    Observable: ``elasticity.scale_up/scale_down/shed/recover``
    counters, ``elasticity.<model>.{desired_replicas,burn}`` gauges and
    ``elasticity`` tracer events.  ``poll(now=)`` is injectable for
    deterministic tests; :meth:`start` runs it on a daemon thread."""

    def __init__(self, registry: ModelRegistry,
                 rules_for: Optional[Callable[[str], list]] = None, *,
                 scaler: Optional[Callable[[str, int], None]] = None,
                 objective_ms: float = 250.0, window: float = 30.0,
                 min_count: int = 8,
                 min_replicas: int = 1, max_replicas: int = 4,
                 scale_up_burn: float = 1.0, scale_down_burn: float = 0.5,
                 breach_polls: int = 2, clear_polls: int = 3,
                 cooldown_s: float = 30.0, poll_s: float = 2.0):
        if min_replicas < 0 or max_replicas < max(min_replicas, 1):
            raise ValueError("need 0 <= min_replicas <= max_replicas "
                             "and max_replicas >= 1")
        self.registry = registry
        self.scaler = scaler
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_burn = float(scale_up_burn)
        self.scale_down_burn = float(scale_down_burn)
        self.breach_polls = int(breach_polls)
        self.clear_polls = int(clear_polls)
        self.cooldown_s = float(cooldown_s)
        self.poll_s = float(poll_s)
        if rules_for is None:
            from ..observability.slo import SLORule

            def rules_for(name: str):
                return [SLORule(f"serving.engine.{name}.latency_ms",
                                objective_ms, window=window,
                                quantile=0.99, min_count=min_count,
                                name=f"{name}_p99_latency_ms")]
        self._rules_for = rules_for
        self._mu = threading.Lock()
        self._monitors: Dict[str, object] = {}
        self._state: Dict[str, dict] = {}   # per-model control state
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _emit(self, event: str, **args) -> None:
        trc = obs_hook._tracer
        if trc is not None:
            trc.emit("elasticity", event, args=args)

    def _collect_incident(self, name: str, burn: float) -> None:
        spool = flags.get_flag("obs_spool_dir")
        if not spool:
            return
        try:
            from ..observability import fleet as _fleet
            _fleet.collect_fleet_bundle(
                os.path.join(spool, f"incident_shed_{name}"),
                reason=f"registry.shed:{name}",
                extra={"model": name, "burn": round(burn, 3)})
        except Exception:   # telemetry must never break the control loop
            pass

    def _model_state(self, name: str) -> dict:
        return self._state.setdefault(name, {
            "desired": self.min_replicas, "breach": 0, "clear": 0,
            "cooldown_until": 0.0})

    def _scale(self, name: str, st: dict, desired: int,
               now: float) -> None:
        st["desired"] = desired
        st["cooldown_until"] = now + self.cooldown_s
        st["breach"] = st["clear"] = 0
        monitor.stat_set(f"elasticity.{name}.desired_replicas", desired)
        if self.scaler is not None:
            self.scaler(name, desired)

    def poll(self, now: Optional[float] = None) -> dict:
        """One control-loop evaluation over every ready model; returns
        ``{model: {burn, desired, shedding, breached}}``.  ``now``
        (monotonic seconds) feeds the SLO windows AND the cooldown
        clock, so tests drive time explicitly."""
        import math
        now = time.monotonic() if now is None else float(now)
        out: Dict[str, dict] = {}
        with self.registry._mu:
            entries = {n: e for n, e in self.registry._models.items()
                       if e.state == "ready"}
        with self._mu:
            for name in list(self._monitors):
                if name not in entries:     # unloaded: drop its loop
                    del self._monitors[name]
                    self._state.pop(name, None)
            for name, entry in entries.items():
                from ..observability.slo import SLOMonitor
                mon = self._monitors.get(name)
                if mon is None:
                    mon = self._monitors[name] = SLOMonitor(
                        self._rules_for(name))
                status = mon.poll(now=now)
                burns = [r["burn"] for r in status["rules"]
                         if isinstance(r["burn"], (int, float))]
                burn = max(burns) if burns else 0.0
                breached = bool(status["breached"])
                st = self._model_state(name)
                monitor.stat_set(
                    f"elasticity.{name}.burn",
                    round(burn, 6) if math.isfinite(burn) else 1e12)
                in_cooldown = now < st["cooldown_until"]
                if burn >= self.scale_up_burn:
                    st["breach"] += 1
                    st["clear"] = 0
                    if (st["breach"] >= self.breach_polls
                            and not in_cooldown):
                        if st["desired"] < self.max_replicas:
                            self._scale(name, st, st["desired"] + 1, now)
                            monitor.stat_add("elasticity.scale_up")
                            self._emit("scale_up", model=name,
                                       desired=st["desired"],
                                       burn=round(burn, 3))
                        elif not entry.shedding:
                            # at max capacity and still burning: shed
                            entry.shedding = True
                            monitor.stat_add("elasticity.shed")
                            self._emit("shed", model=name,
                                       burn=round(burn, 3))
                            # a shed decision is a registry incident:
                            # when the fleet is spooling, capture every
                            # process's black box for the post-mortem
                            self._collect_incident(name, burn)
                elif burn <= self.scale_down_burn:
                    st["clear"] += 1
                    st["breach"] = 0
                    if entry.shedding:
                        entry.shedding = False
                        monitor.stat_add("elasticity.recover")
                        self._emit("recover", model=name)
                    if (st["clear"] >= self.clear_polls
                            and not in_cooldown
                            and st["desired"] > self.min_replicas):
                        self._scale(name, st, st["desired"] - 1, now)
                        monitor.stat_add("elasticity.scale_down")
                        self._emit("scale_down", model=name,
                                   desired=st["desired"])
                else:       # between thresholds: hysteresis band
                    st["breach"] = st["clear"] = 0
                out[name] = {"burn": burn, "desired": st["desired"],
                             "shedding": entry.shedding,
                             "breached": breached}
        return out

    def status(self) -> dict:
        with self._mu:
            return {n: dict(st) for n, st in self._state.items()}

    def start(self) -> "ElasticityController":
        if self._thread is not None:
            raise RuntimeError("controller already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    self.poll()
                except Exception:   # registry churn mid-poll: retry next
                    pass

        self._thread = threading.Thread(target=loop, name="elasticity",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
