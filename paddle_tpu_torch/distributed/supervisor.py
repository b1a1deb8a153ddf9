"""Supervised training and serving: hang detection, kill, restart,
resume (the counterpart of ``paddle_tpu/distributed/supervisor.py``).

:class:`TrainingSupervisor` runs a training entrypoint in a child
process and keeps it alive to the end:

* The child stamps a :class:`HeartbeatWriter` beat on every static
  ``Executor`` run (one ``obs_hook`` None check when unsupervised).
  Each beat carries the wall time, the run counter, the build's
  ``predicted_step_s`` (the cost model's chip row: ``h100`` on the
  card) and the interval since the previous beat, checksummed against
  torn reads.
* The parent's :class:`StepWatchdog` derives a per-step deadline from
  ``predicted_step_s`` times a drift factor (observed median over
  predicted, clamped), falling back to a rolling p99 of observed step
  times when no prediction exists.  A deadlocked collective never
  raises; it stops beating.
* A missed deadline escalates SIGTERM, then SIGKILL: a slow child can
  still save at the next step boundary and exit (``TrainEpochRange``'s
  preemption save); a wedged one is killed after ``hang_grace_s``.
* Every exit other than a clean ``0`` restarts the child with
  exponential backoff, bounded by a crash budget (``crash_budget``
  failures inside ``crash_window_s`` raise :class:`SupervisorGaveUp`
  with the whole ``exit_history``) and ``max_restarts``.
* On restart the entrypoint runs afresh: it resumes from the newest
  intact snapshot through ``SnapshotStore`` (``ShardedState`` reshards
  onto however many ranks the new incarnation has).
* Every decision is observable: ``supervisor.*`` monitor stats, tracer
  events, and flight dumps at kill time and at give-up.

The child is started by ``multiprocessing`` with the ``spawn`` method
(a fresh interpreter: forking a parent whose CUDA context or threads
hold state can deadlock the child; ``start_method=`` or
``PADDLE_TPU_TORCH_SUPERVISOR_START`` override it).  ``child_env``
entries are set in ``os.environ`` around the spawn, so settings read at
import (``FLAGS_fault_spec``, ``CUDA_VISIBLE_DEVICES``) reach the
child; a callable ``child_env`` receives the attempt index.  A child
spends seconds importing torch and the port and building its first
step; until its first step beat only ``startup_timeout_s`` applies.

The spawn, heartbeat, backoff and crash-budget core is
:class:`ProcessSupervisor`; a workload varies only the liveness policy
(:meth:`ProcessSupervisor._check_liveness`).  :class:`ServingSupervisor`
supervises a serving replica: the engines stamp a beat per dispatched
batch or decode step, the parent probes ``/healthz``, and a replica is
hung only when the probes fail and its beats went stale (an idle,
answering replica is never killed).
"""
from __future__ import annotations

import math
import os
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

from ..core import flags, obs_hook
from ..utils import monitor

__all__ = ["Heartbeat", "HeartbeatReader", "HeartbeatWriter",
           "ProcessSupervisor", "ServingSupervisor", "StepWatchdog",
           "SupervisorGaveUp", "SupervisorResult", "TrainingSupervisor",
           "current_heartbeat"]


# ---------------------------------------------------------------------------
# Heartbeat transport: one small checksummed record, overwritten in place
# ---------------------------------------------------------------------------

# wall time, step, predicted_step_s, interval_s, checksum(sum of the 4)
_HB_STRUCT = struct.Struct("<5d")


class Heartbeat(NamedTuple):
    time: float                       # wall clock of the beat
    step: int                         # executor run counter (-1 = birth)
    predicted_step_s: Optional[float]  # compile record prediction, if any
    interval_s: float                 # observed gap since previous beat
                                      # (0 = unknown / fresh compile)


class HeartbeatWriter:
    """Child-side stamp: ``beat()`` pwrites one fixed-size record at
    offset 0.  The record carries its own checksum so a reader racing
    the write sees either the old beat or the new one, never a torn
    hybrid.  Cost per beat: one ``struct.pack`` + one ``pwrite`` —
    cheap enough for every step of a hot training loop."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fd = os.open(path, os.O_CREAT | os.O_WRONLY, 0o644)
        self._last: Optional[float] = None

    def beat(self, step: int, predicted: Optional[dict] = None,
             fresh_compile: bool = False) -> None:
        now = time.time()
        # a compile-run's wall is compile time, not step time: mark its
        # interval unknown so the watchdog's window stays a *step*-time
        # distribution (same exclusion the perf observatory applies)
        interval = 0.0
        if self._last is not None and not fresh_compile:
            interval = max(0.0, now - self._last)
        self._last = now
        ps = 0.0
        if predicted:
            ps = float(predicted.get("predicted_step_s") or 0.0)
        vals = (now, float(step), ps, interval)
        os.pwrite(self._fd, _HB_STRUCT.pack(*vals, math.fsum(vals)), 0)

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


class HeartbeatReader:
    """Parent-side probe: ``read()`` returns the newest intact beat or
    None (file absent, not yet written, or a torn record)."""

    def __init__(self, path: str):
        self.path = path
        self._fd: Optional[int] = None

    def read(self) -> Optional[Heartbeat]:
        if self._fd is None:
            try:
                self._fd = os.open(self.path, os.O_RDONLY)
            except OSError:
                return None
        try:
            data = os.pread(self._fd, _HB_STRUCT.size, 0)
        except OSError:
            return None
        if len(data) < _HB_STRUCT.size:
            return None
        t, step, ps, interval, csum = _HB_STRUCT.unpack(data)
        # exact equality on purpose: doubles round-trip struct
        # pack/unpack bit-exactly and fsum is deterministic, so any
        # mismatch at all means a torn record (an isclose-style
        # tolerance on an epoch-seconds-dominated sum would accept
        # hybrids of two adjacent beats)
        if math.fsum((t, step, ps, interval)) != csum:
            return None                      # torn write: keep last view
        return Heartbeat(t, int(step), ps or None, interval)

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None


def current_heartbeat() -> Optional[HeartbeatWriter]:
    """The writer installed in this (supervised) process, or None.
    Training loops that don't go through the static Executor can stamp
    progress themselves: ``hb = current_heartbeat(); hb and hb.beat(i)``.
    """
    return obs_hook._heartbeat


# ---------------------------------------------------------------------------
# Watchdog policy: how long may a step take before we call it a hang?
# ---------------------------------------------------------------------------

class StepWatchdog:
    """Per-step deadline policy.

    With a prediction (the compile record's ``predicted_step_s`` rides
    every beat): ``deadline = predicted * drift * multiplier`` where
    ``drift = clamp(median(observed) / predicted, 1, drift_cap)`` — a
    model whose real steps run slower than priced (CPU fallback, a
    congested interconnect) widens its own deadline instead of getting
    killed for honest slowness, but never narrows below the prediction.

    Without a prediction: ``deadline = p99(observed) * multiplier`` over
    a rolling window.  Before any observation: ``max_deadline_s``.
    Either way the deadline only *applies* once the current child has
    produced a step beat — until then (imports, restore, compile) the
    supervisor's ``startup_timeout_s`` is the only clock, which is what
    lets :meth:`reset` keep the observed window across restarts without
    a restarted child's recompile being judged at step scale.  The
    result is always clamped to
    ``[min_deadline_s, max_deadline_s]`` (steps on fast chips are
    micro-seconds — an unclamped deadline would kill on any GC pause).
    """

    def __init__(self, multiplier: float = 8.0, min_deadline_s: float = 5.0,
                 max_deadline_s: float = 900.0, drift_cap: float = 4.0,
                 window: int = 128):
        if multiplier <= 0 or min_deadline_s <= 0:
            raise ValueError("watchdog multiplier/min_deadline_s must be "
                             "positive")
        if max_deadline_s < min_deadline_s:
            raise ValueError("watchdog max_deadline_s < min_deadline_s")
        self.multiplier = float(multiplier)
        self.min_deadline_s = float(min_deadline_s)
        self.max_deadline_s = float(max_deadline_s)
        self.drift_cap = float(drift_cap)
        self._intervals: deque = deque(maxlen=int(window))
        self._last_step: Optional[int] = None
        self._predicted: Optional[float] = None

    def observe(self, hb: Optional[Heartbeat]) -> None:
        if hb is None:
            return
        if hb.step != self._last_step:       # dedupe repeated reads
            self._last_step = hb.step
            if hb.interval_s > 0.0:
                self._intervals.append(hb.interval_s)
        if hb.predicted_step_s:
            self._predicted = hb.predicted_step_s

    def _quantile(self, q: float) -> float:
        vals = sorted(self._intervals)
        return vals[min(len(vals) - 1, int(math.ceil(q * len(vals))) - 1)]

    def drift(self) -> float:
        """Observed-vs-predicted slowdown factor, clamped to
        ``[1, drift_cap]``; 1.0 when either side is unknown."""
        if not self._predicted or not self._intervals:
            return 1.0
        return min(self.drift_cap,
                   max(1.0, self._quantile(0.5) / self._predicted))

    def deadline_s(self) -> float:
        if self._predicted:
            d = self._predicted * self.drift() * self.multiplier
        elif self._intervals:
            d = self._quantile(0.99) * self.multiplier
        else:
            d = self.max_deadline_s
        return min(self.max_deadline_s, max(self.min_deadline_s, d))

    def reset(self) -> None:
        """Fresh child: drop the prediction (it recompiles) but keep the
        observed window — the workload, and therefore the step-time
        distribution, survives a restart."""
        self._predicted = None
        self._last_step = None


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------

class SupervisorGaveUp(RuntimeError):
    """Restart budget exhausted: the job is crash-looping (or exceeded
    ``max_restarts``).  ``exit_history`` carries every attempt's exit
    record so the operator sees *what* kept dying, not just that
    something did."""

    def __init__(self, msg: str, exit_history: List[dict]):
        super().__init__(msg)
        self.exit_history = list(exit_history)


@dataclass
class SupervisorResult:
    """Outcome of a supervised run that ended without giving up."""
    clean_exit: bool                  # child returned 0 un-killed
    stopped: bool = False             # supervisor.stop() / SIGTERM ended it
    attempts: int = 0                 # children started
    restarts: int = 0
    hang_kills: int = 0
    exit_history: List[dict] = field(default_factory=list)


def _child_main(entry, args, kwargs, hb_path):
    """Child bootstrap: install the heartbeat writer, stamp a birth
    beat (the watchdog's startup clock anchor), then hand off to the
    training entrypoint.  Runs in a fresh interpreter under ``spawn``,
    so module state (fault arming from ``FLAGS_fault_spec``, the
    visible cards from ``CUDA_VISIBLE_DEVICES``) initializes from the
    environment the supervisor staged."""
    w = HeartbeatWriter(hb_path)
    obs_hook.set_heartbeat(w)
    w.beat(step=-1)
    entry(*args, **(kwargs or {}))


class _patched_env:
    """Apply env overrides for the duration of a child spawn (spawn
    inherits ``os.environ`` at exec time).  A None value deletes."""

    def __init__(self, overrides: dict):
        self._overrides = dict(overrides)

    def __enter__(self):
        self._saved = {k: os.environ.get(k) for k in self._overrides}
        for k, v in self._overrides.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        return self

    def __exit__(self, *exc_info):
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


class ProcessSupervisor:
    """Run ``entry(*args, **kwargs)`` in a supervised child process and
    keep it alive until it exits cleanly, the restart budget runs out,
    or :meth:`stop` is called.

    ``entry`` must be picklable (module-level callable) under the
    chosen start method.  The entrypoint owns resume semantics: on every
    (re)start it should re-detect its environment and restore from its
    durable state — the supervisor guarantees only *that* it runs again,
    with backoff, and that wedged incarnations die.

    Subclasses specialise the *liveness policy* by overriding
    :meth:`_check_liveness` (and per-attempt state via
    :meth:`_attempt_reset`); spawn, kill escalation, backoff, the crash
    budget, exit history and the flight dumps are shared.
    ``stat_ns`` namespaces the monitor counters (``supervisor.*`` for
    training — the original namespace — ``supervisor.serving.*`` for
    replicas).
    """

    stat_ns = "supervisor"

    def __init__(self, entry: Callable, args: Sequence = (), kwargs=None,
                 *, name: str = "job",
                 watchdog: Optional[StepWatchdog] = None,
                 startup_timeout_s: Optional[float] = 300.0,
                 hang_grace_s: float = 10.0,
                 poll_s: float = 0.25,
                 max_restarts: int = 16,
                 backoff_s: float = 1.0, backoff_max_s: float = 60.0,
                 crash_window_s: float = 300.0, crash_budget: int = 3,
                 child_env: Union[dict, Callable[[int], dict], None] = None,
                 start_method: Optional[str] = None,
                 workdir: Optional[str] = None,
                 dump_flight_on_kill: bool = True):
        self.entry = entry
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.name = name
        self.watchdog = watchdog if watchdog is not None else StepWatchdog()
        self.startup_timeout_s = startup_timeout_s
        self.hang_grace_s = float(hang_grace_s)
        self.poll_s = float(poll_s)
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.crash_window_s = float(crash_window_s)
        self.crash_budget = int(crash_budget)
        self._child_env = child_env
        self._method = (start_method
                        or os.environ.get("PADDLE_TPU_TORCH_SUPERVISOR_START")
                        or "spawn")
        self._workdir = workdir
        self._own_workdir: Optional[str] = None
        self.dump_flight_on_kill = dump_flight_on_kill
        self.exit_history: List[dict] = []
        self.last_heartbeat: Optional[Heartbeat] = None
        self._stop = threading.Event()
        self._proc = None

    # -- observability -----------------------------------------------------
    def _stat(self, suffix: str, v=1) -> None:
        monitor.stat_add(f"{self.stat_ns}.{suffix}", v)

    def _emit(self, action: str, **args) -> None:
        trc = obs_hook._tracer
        if trc is not None:
            trc.emit("supervisor", action,
                     args=dict(args, name=self.name))

    # -- knobs -------------------------------------------------------------
    def _env_for(self, attempt: int) -> dict:
        env = self._child_env
        if env is None:
            out = {}
        elif callable(env):
            out = dict(env(attempt) or {})
        else:
            out = dict(env)
        # fleet telemetry staging: when this process spools, children
        # spool too — flags seed from FLAGS_* env at define time, so a
        # spawn child's fresh interpreter picks these up with zero code
        # changes in the entrypoint.  setdefault keeps an explicit
        # child_env override (or a disable via None) authoritative.
        spool = flags.get_flag("obs_spool_dir")
        if spool:
            out.setdefault("FLAGS_obs_spool_dir", spool)
            out.setdefault("FLAGS_obs_role", f"{self.name}-a{attempt}")
        return out

    def _dir(self) -> str:
        if self._workdir is None:
            import tempfile
            self._own_workdir = tempfile.mkdtemp(
                prefix=f"supervisor_{self.name}_")
            self._workdir = self._own_workdir
        return self._workdir

    def stop(self) -> None:
        """Ask the watch loop to end supervision: the child gets a
        SIGTERM (boundary-save semantics), then a grace-bounded wait —
        no restart follows.  Safe from any thread or signal handler."""
        self._stop.set()

    # -- kill path ---------------------------------------------------------
    def _dump_kill_flight(self, reason: str, attempt: int,
                          hb: Optional[Heartbeat], deadline: float) -> None:
        if not self.dump_flight_on_kill:
            return
        from ..observability.flight import dump_flight
        path = os.path.join(self._dir(),
                            f"supervisor_kill_a{attempt}.json")
        try:
            dump_flight(path, reason=f"supervisor.{reason}", extra={
                "supervisor": self.name,
                "restart_reason": reason,
                "attempt": attempt,
                "last_step": None if hb is None else hb.step,
                "last_beat_age_s": (None if hb is None
                                    else time.time() - hb.time),
                "deadline_s": deadline,
                "exit_history": list(self.exit_history),
            })
        except Exception as e:  # noqa: BLE001 - the kill must proceed
            import warnings
            warnings.warn(f"supervisor: kill-time flight dump failed: {e}")

    def _child_dump_paths(self) -> List[str]:
        """Every per-attempt black box the dead children left in the
        workdir (kill-time flight dumps, the children's own crash
        dumps): the give-up record points at all of them so the
        post-mortem needs no directory spelunking."""
        import glob as _glob
        out: List[str] = []
        for pat in ("supervisor_kill_a*.json", "flight_record*.json",
                    "*_flight.json"):
            out.extend(_glob.glob(os.path.join(self._dir(), pat)))
        return sorted(set(out))

    def _dump_giveup_flight(self, attempts: int,
                            recent_failures: int) -> None:
        if not self.dump_flight_on_kill:
            return
        from ..observability.flight import dump_flight
        path = os.path.join(self._dir(), "supervisor_giveup.json")
        hb = self.last_heartbeat
        try:
            dump_flight(path, reason="supervisor.give_up", extra={
                "supervisor": self.name,
                "attempts": attempts,
                "recent_failures": recent_failures,
                "crash_window_s": self.crash_window_s,
                "crash_budget": self.crash_budget,
                "max_restarts": self.max_restarts,
                "exit_history": list(self.exit_history),
                "child_dumps": self._child_dump_paths(),
                # inlined, not just pointed at: the heartbeat file is
                # a binary record that an operator reading one JSON
                # dump should not have to decode
                "last_heartbeat": None if hb is None else {
                    "time": hb.time,
                    "step": hb.step,
                    "predicted_step_s": hb.predicted_step_s,
                    "interval_s": hb.interval_s,
                    "age_s": round(time.time() - hb.time, 3),
                },
            })
        except Exception as e:  # noqa: BLE001 - give-up must proceed
            import warnings
            warnings.warn(
                f"supervisor: give-up flight dump failed: {e}")
        # when the fleet is spooling, a give-up is a fleet incident:
        # collect every process's telemetry (this parent's lane
        # included) next to the give-up dump
        if flags.get_flag("obs_spool_dir"):
            try:
                from ..observability import fleet
                fleet.collect_fleet_bundle(
                    os.path.join(self._dir(), "fleet_bundle"),
                    extra_paths=self._child_dump_paths() + [path],
                    reason=f"supervisor.give_up:{self.name}",
                    extra={"attempts": attempts,
                           "recent_failures": recent_failures})
            except Exception as e:  # noqa: BLE001
                import warnings
                warnings.warn(
                    f"supervisor: fleet bundle collection failed: {e}")

    def _kill(self, proc, reason: str, attempt: int,
              hb: Optional[Heartbeat], deadline: float) -> None:
        """SIGTERM → grace → SIGKILL.  SIGTERM first on purpose: a slow
        (not wedged) child saves at the next step boundary and exits 0;
        a wedged one ignores it and is SIGKILLed."""
        # 'never beat' and 'stopped beating mid-step' are different
        # diagnoses (environment/startup vs collective deadlock) —
        # keep their counters distinct for whoever alerts on them
        self._stat({"hang": "hang_kills",
                    "startup_timeout": "startup_timeouts"}.get(
                        reason, f"{reason}_kills"))
        self._emit("kill", reason=reason, attempt=attempt,
                   step=None if hb is None else hb.step,
                   deadline_s=round(deadline, 3))
        self._dump_kill_flight(reason, attempt, hb, deadline)
        proc.terminate()
        proc.join(self.hang_grace_s)
        if proc.exitcode is None:
            proc.kill()
            proc.join()

    # -- liveness policy (the subclass hook) --------------------------------
    def _attempt_reset(self) -> None:
        """Per-child-start state reset (a restarted child recompiles /
        re-warms from scratch — stale per-attempt judgments must not
        carry over)."""
        self.watchdog.reset()

    def _check_liveness(self, hb: Optional[Heartbeat], seen_step: bool,
                        started: float) -> Optional[str]:
        """One poll's verdict on the running child: a kill reason
        (``"hang"`` / ``"startup_timeout"`` / policy-specific) or None
        while the child is considered live.  Default policy: the
        training step watchdog."""
        if not seen_step:
            # startup phase: THIS child has produced no step beat yet
            # (birth beat is step -1) — it is importing, restoring, or
            # compiling, and the step-scale watchdog deadline does not
            # apply (restarted children recompile from scratch; the
            # retained interval window must not kill them)
            if (self.startup_timeout_s is not None
                    and time.monotonic() - started
                    > self.startup_timeout_s):
                return "startup_timeout"
            return None
        deadline = self.watchdog.deadline_s()
        if time.time() - hb.time > deadline:
            return "hang"
        return None

    # -- main loop ---------------------------------------------------------
    def run(self) -> SupervisorResult:
        import multiprocessing as mp
        ctx = mp.get_context(self._method)
        attempt = 0
        consecutive = 0
        hang_kills = 0
        self._stop.clear()
        # per-run history: a re-run after stop()/give-up starts with a
        # clean crash-budget window (the raised SupervisorGaveUp keeps
        # its own copy of the old history)
        self.exit_history = []
        while True:
            hb_path = os.path.join(self._dir(), f"heartbeat_a{attempt}")
            try:
                os.remove(hb_path)
            except OSError:
                pass
            env = self._env_for(attempt)
            with _patched_env(env):
                proc = ctx.Process(
                    target=_child_main,
                    args=(self.entry, self.args, self.kwargs, hb_path),
                    name=f"supervised-{self.name}-{attempt}")
                proc.start()
            self._proc = proc
            self._stat("starts")
            self._emit("start", attempt=attempt, pid=proc.pid,
                       env={k: str(v) for k, v in env.items()})
            self._attempt_reset()
            reader = HeartbeatReader(hb_path)
            started = time.monotonic()
            kill_reason = None
            hb = None               # last GOOD beat (a torn read must
            seen_step = False       # not erase the last known view)
            while True:
                proc.join(self.poll_s)
                if proc.exitcode is not None:
                    break
                if self._stop.is_set():
                    kill_reason = "stopped"
                    break
                fresh = reader.read()
                if fresh is not None:
                    hb = fresh
                    self.watchdog.observe(fresh)
                    if fresh.step >= 0:
                        seen_step = True
                reason = self._check_liveness(hb, seen_step, started)
                if reason is not None:
                    kill_reason = reason
                    break
            stopped = self._stop.is_set()
            if kill_reason == "stopped":
                self._emit("stop", attempt=attempt)
                proc.terminate()
                proc.join(max(self.hang_grace_s, 30.0))
                if proc.exitcode is None:
                    proc.kill()
                    proc.join()
            elif kill_reason is not None:
                if kill_reason == "hang":
                    hang_kills += 1
                self._kill(proc, kill_reason, attempt, hb,
                           self.watchdog.deadline_s())
            # the child may have beaten between the last poll and its
            # exit — the record's last_step diagnostic must see the
            # freshest beat, not one up to poll_s stale
            final_hb = reader.read()
            if final_hb is not None:
                self.watchdog.observe(final_hb)
                hb = final_hb
            reader.close()
            self.last_heartbeat = hb
            self._proc = None
            code = proc.exitcode
            rec = {
                "attempt": attempt,
                "exit_code": code,
                "reason": (kill_reason if kill_reason is not None
                           else ("clean" if code == 0
                                 else f"crash(exit={code})")),
                # NOTE: per-incarnation counter (the Executor's run
                # count restarts at 1 in every child) — diagnostic
                # context, not comparable across attempts
                "last_step": None if hb is None else hb.step,
                "runtime_s": round(time.monotonic() - started, 3),
                "time": time.time(),
            }
            attempt += 1
            if stopped:
                self.exit_history.append(rec)
                self._stat("stopped")
                return SupervisorResult(
                    clean_exit=(code == 0), stopped=True, attempts=attempt,
                    restarts=attempt - 1, hang_kills=hang_kills,
                    exit_history=self.exit_history)
            if code == 0 and kill_reason is None:
                self._stat("clean_exits")
                self._emit("clean_exit", attempt=attempt - 1)
                return SupervisorResult(
                    clean_exit=True, attempts=attempt,
                    restarts=attempt - 1, hang_kills=hang_kills,
                    exit_history=self.exit_history)
            # a failure (crash, or a kill — even one that boundary-saved
            # and exited 0): record, budget-check, back off, restart
            self.exit_history.append(rec)
            if kill_reason is None:
                self._stat("crashes")
            # backoff resets when the incarnation survived the whole
            # crash window — by then earlier failures have aged out of
            # the budget anyway, and a job inching forward through
            # occasional node deaths must not accumulate the backoff
            # of a true crash loop.  (The heartbeat step counter can't
            # drive this: it is per-incarnation, not a global step.)
            if rec["runtime_s"] >= self.crash_window_s:
                consecutive = 1
            else:
                consecutive += 1
            self._emit("exit", **rec)
            now = time.time()
            recent = [r for r in self.exit_history
                      if now - r["time"] <= self.crash_window_s]
            if attempt - 1 >= self.max_restarts \
                    or len(recent) > self.crash_budget:
                self._stat("gave_up")
                self._emit("give_up", attempts=attempt,
                           recent_failures=len(recent))
                summary = [(r["reason"], r["exit_code"])
                           for r in self.exit_history]
                # the final black box: a crash-loop give-up is the one
                # exit that leaves NO incarnation behind to explain
                # itself (watchdog kills dump per-attempt, but a crash
                # that exhausts the budget has no kill-time dump) —
                # annotate a last flight dump with the full exit
                # history so the post-mortem starts with evidence
                self._dump_giveup_flight(attempt, len(recent))
                raise SupervisorGaveUp(
                    f"supervisor '{self.name}' giving up after "
                    f"{attempt} attempt(s): {len(recent)} failure(s) "
                    f"inside {self.crash_window_s:.0f}s (budget "
                    f"{self.crash_budget}); exit history: {summary}",
                    self.exit_history)
            backoff = min(self.backoff_s * (2 ** (consecutive - 1)),
                          self.backoff_max_s)
            self._stat("restarts")
            self._stat("backoff_total_s", backoff)
            self._emit("restart", attempt=attempt,
                       backoff_s=round(backoff, 3), reason=rec["reason"])
            # interruptible: stop() during backoff ends supervision
            if self._stop.wait(backoff):
                self._stat("stopped")
                return SupervisorResult(
                    clean_exit=False, stopped=True, attempts=attempt,
                    restarts=attempt - 1, hang_kills=hang_kills,
                    exit_history=self.exit_history)


class TrainingSupervisor(ProcessSupervisor):
    """Supervise a *training* entrypoint: liveness is the per-step
    deadline from :class:`StepWatchdog` over the Executor's heartbeats
    (the original PR-12 policy, inherited unchanged from
    :class:`ProcessSupervisor`'s default ``_check_liveness``).  Stats
    stay in the original ``supervisor.*`` namespace."""

    def __init__(self, entry: Callable, args: Sequence = (), kwargs=None,
                 *, name: str = "train", **kw):
        super().__init__(entry, args, kwargs, name=name, **kw)


class ServingSupervisor(ProcessSupervisor):
    """Supervise a *serving replica*: the child runs a serving
    entrypoint (engine + ``serving.ServingServer``)
    and stamps a heartbeat per dispatched batch / decode step through
    the same ``obs_hook`` slot training uses.

    Serving liveness differs from training in one fundamental way: an
    idle replica legitimately stops beating (no traffic, no dispatches),
    so stale beats alone must never kill it.  The policy here is
    conjunctive — a replica is declared hung only when its HTTP plane
    has failed ``ready_fail_budget`` consecutive ``/healthz`` probes
    *and* its newest dispatch beat is older than ``hang_deadline_s``.
    A responsive-but-quiet replica survives; a replica whose dispatcher
    wedged mid-batch keeps answering probes only until the server
    thread pool saturates, then fails both clocks and dies.

    Readiness (HTTP 200 from ``/healthz``; 503 during warmup/drain) is
    tracked as :attr:`ready` with transitions counted
    (``supervisor.serving.ready_transitions``) and emitted on the
    tracer — a warm restart is observable as not-ready → re-warm →
    ready.  Until the replica has been ready once (or produced a
    dispatch beat), ``startup_timeout_s`` is the only clock, exactly
    like training's compile window.  Without a ``health_url`` the
    supervisor degrades to crash-restart-only: no probe means no hang
    verdict, because beats alone cannot distinguish wedged from idle.
    """

    stat_ns = "supervisor.serving"

    def __init__(self, entry: Callable, args: Sequence = (), kwargs=None,
                 *, name: str = "serve", health_url: Optional[str] = None,
                 ready_poll_s: float = 0.5, probe_timeout_s: float = 2.0,
                 ready_fail_budget: int = 6, hang_deadline_s: float = 60.0,
                 **kw):
        super().__init__(entry, args, kwargs, name=name, **kw)
        self.health_url = health_url
        self.ready_poll_s = float(ready_poll_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.ready_fail_budget = int(ready_fail_budget)
        self.hang_deadline_s = float(hang_deadline_s)
        self.ready = False
        self._probe_failures = 0
        self._ever_ready = False
        self._last_probe = 0.0

    def _attempt_reset(self) -> None:
        super()._attempt_reset()
        # a fresh incarnation starts un-probed and not ready: its
        # predecessor's probe verdicts must not kill (or vouch for) it
        self._probe_failures = 0
        self._ever_ready = False
        self._last_probe = 0.0
        self._set_ready(False)

    def _set_ready(self, ready: bool) -> None:
        if ready == self.ready:
            return
        self.ready = ready
        self._stat("ready_transitions")
        self._stat("ready_up" if ready else "ready_down")
        self._emit("ready" if ready else "unready")
        if ready:
            self._ever_ready = True

    def _probe(self):
        """One stdlib HTTP GET against ``health_url``.  Returns
        ``(reachable, ready)``: reachable means the HTTP plane answered
        at all (any status), ready means it answered 200."""
        import http.client
        from urllib.parse import urlparse
        u = urlparse(self.health_url)
        conn = http.client.HTTPConnection(
            u.hostname, u.port or 80, timeout=self.probe_timeout_s)
        try:
            conn.request("GET", u.path or "/healthz")
            status = conn.getresponse().status
            return True, status == 200
        except (OSError, http.client.HTTPException):
            return False, False
        finally:
            conn.close()

    def _check_liveness(self, hb: Optional[Heartbeat], seen_step: bool,
                        started: float) -> Optional[str]:
        now = time.monotonic()
        if self.health_url is not None \
                and now - self._last_probe >= self.ready_poll_s:
            self._last_probe = now
            reachable, is_ready = self._probe()
            self._set_ready(is_ready)
            self._probe_failures = 0 if reachable else \
                self._probe_failures + 1
        if not self._ever_ready and not seen_step:
            # startup / warm-restart window: importing, loading the
            # artifact, AOT-warming buckets — only the startup clock
            # applies until readiness (or the first dispatch beat)
            if (self.startup_timeout_s is not None
                    and now - started > self.startup_timeout_s):
                return "startup_timeout"
            return None
        if self.health_url is None:
            return None          # beats alone can't tell wedged from idle
        if self._probe_failures > self.ready_fail_budget \
                and (hb is None
                     or time.time() - hb.time > self.hang_deadline_s):
            return "hang"
        return None
