"""Host-side data-plane anomaly policy: detect, agree, skip,
quarantine, roll back (the counterpart of
``paddle_tpu/distributed/anomaly.py``).

The division of labour:

* **In the step** (``static/executor.py`` and ``distributed/grad_comm.py``
  under ``FLAGS_anomaly_sentry``): the gradients' non-finite counts and
  squared norm collapse into one flag on the device, summed over the dp
  group so every replica takes the same branch, and a flagged step is
  a bitwise no-op on the carried state with no host read.  The step
  handles containment.
* **On the host** (this module): :class:`AnomalyPolicy` reads the
  sentry's scan of each step plus a rolling-median loss-spike detector
  (the net for finite corruption, such as a bitflipped payload, that a
  non-finite scan cannot flag) and drives the escalation ladder:

  1. **skip**: the step already dropped the update; the loop should
     re-deliver the same batch;
  2. **quarantine**: the batch kept flagging past
     ``FLAGS_anomaly_skip_budget`` consecutive skips: it goes on the
     blame ledger and the loop advances past it;
  3. **rollback**: anomalies persist past a quarantine: restore the
     newest intact snapshot through ``utils.checkpoint.SnapshotStore``
     and re-seed the data order (:attr:`AnomalyPolicy.data_seed`
     bumps);
  4. **give up**: ``FLAGS_anomaly_rollback_budget`` rollbacks did not
     help: raise :class:`AnomalyEscalation`, which ends the incarnation
     so a ``TrainingSupervisor`` restarts it.

Observability: every decision lands in ``anomaly.*`` monitor stats
(``skips``, ``quarantines``, ``rollbacks``, ``loss_spikes``,
``giveups``, per-bucket ``anomaly.bucket.<i>.nonfinite``,
``grad_comm.nonfinite_blocks``, the ``anomaly.grad_norm`` gauge), as
``anomaly`` tracer events, and a rollback writes an annotated flight
dump (reason ``anomaly.rollback``) when a flight recorder is installed.

The sentry's values arrive as tensors (on the card, CUDA ones); the
policy reads them on the host: one sync a step (``sync=True``), or one
step late (``sync=False``).  The Executor's host-side lr schedule
counts runs, so a skipped step moves a run-based lr schedule by one
while Adam's update count (on the device) does not move.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import obs_hook
from ..core.flags import get_flag
from ..utils import monitor

__all__ = ["AnomalyEscalation", "AnomalyPolicy"]


def _host(v) -> np.ndarray:
    """A sentry value or fetch on the host (tensors are copied there)."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class AnomalyEscalation(RuntimeError):
    """The anomaly ladder ran out of rungs (skip budget, quarantine and
    rollback budget all exhausted): the incarnation gives up so the
    TrainingSupervisor's restart path takes over.  Carries the
    quarantine blame ``ledger`` and the per-event ``history``."""

    def __init__(self, msg: str, ledger: List[dict],
                 history: List[dict]):
        super().__init__(msg)
        self.ledger = list(ledger)
        self.history = list(history)


class AnomalyPolicy:
    """Escalation ladder over the in-graph sentry's per-step verdict.

    Install with :meth:`install` (the static Executor then calls
    :meth:`on_step` after every sentry-compiled train dispatch), tell
    it which batch is in flight with :meth:`note_batch`, and consult
    :meth:`poll` after each ``exe.run`` for the action the loop should
    take::

        policy = AnomalyPolicy(store=store, objects={"train": ss})
        policy.install()
        while applied < steps:
            xb, yb = loader.fetch_batch(cursor)
            policy.note_batch(cursor)
            out = exe.run(main, feed={"x": xb, "y": yb},
                          fetch_list=[loss])
            act = policy.poll()
            if act == "ok":
                applied += 1; cursor += 1
            elif act == "skip":
                pass                       # re-deliver the same batch
            elif act == "quarantine":
                cursor += 1                # blamed; move past it
            elif act == "rollback":
                applied = cursor = policy.resume_step

    ``store``/``objects`` are the :class:`SnapshotStore` and the
    registered snapshot objects rollback restores (omit both to cap the
    ladder at quarantine); ``on_rollback`` is called with the restored
    snapshot's meta entry (re-seed shuffling, reset iterators).

    ``sync=True`` (default) reads the sentry flag on the step that
    produced it — one host sync per step, the right trade for drills
    and supervised production loops that already fetch the loss.
    ``sync=False`` defers each verdict to the *next* ``on_step``, so
    the async dispatch pipeline never stalls; every action then lands
    one step late (the in-graph skip itself is never delayed — only
    the host escalation is).
    """

    def __init__(self, store=None, objects: Optional[Dict] = None,
                 loss_name: Optional[str] = None,
                 skip_budget: Optional[int] = None,
                 rollback_budget: Optional[int] = None,
                 spike_window: Optional[int] = None,
                 spike_factor: Optional[float] = None,
                 on_rollback: Optional[Callable] = None,
                 sync: bool = True):
        if (store is None) != (objects is None):
            raise ValueError("AnomalyPolicy: pass store AND objects "
                             "(or neither) — rollback needs both")
        self.store = store
        self.objects = dict(objects) if objects else None
        self.loss_name = loss_name
        self.skip_budget = int(skip_budget
                               if skip_budget is not None
                               else get_flag("anomaly_skip_budget"))
        self.rollback_budget = int(
            rollback_budget if rollback_budget is not None
            else get_flag("anomaly_rollback_budget"))
        self.spike_factor = float(
            spike_factor if spike_factor is not None
            else get_flag("anomaly_spike_factor"))
        self.on_rollback = on_rollback
        self.sync = bool(sync)
        window = int(spike_window if spike_window is not None
                     else get_flag("anomaly_spike_window"))
        self._losses: deque = deque(maxlen=max(window, 2))
        # ladder state
        self._consecutive = 0
        self.skips = 0
        self.rollbacks = 0
        self.loss_spikes = 0
        self.ledger: List[dict] = []       # quarantine blame ledger
        self.quarantined: set = set()      # batch ids of THIS timeline
        self.history: List[dict] = []      # every non-ok decision
        self.resume_step: Optional[int] = None
        self.data_seed = 0                 # bumps per rollback
        self._batch = None
        self._last = "ok"
        self._pending = None               # deferred (sync=False) step

    # -- wiring ------------------------------------------------------------
    def install(self) -> "AnomalyPolicy":
        """Make this the process-wide policy the Executor notifies."""
        obs_hook.set_anomaly_policy(self)
        return self

    def uninstall(self) -> None:
        if obs_hook._anomaly is self:
            obs_hook.set_anomaly_policy(None)

    def note_batch(self, batch_id) -> None:
        """Name the batch now in flight — the quarantine blame target."""
        self._batch = batch_id

    def poll(self) -> str:
        """The decision for the step(s) observed since the last poll:
        ``"ok"`` | ``"skip"`` | ``"quarantine"`` | ``"rollback"`` —
        reading it resets the slot to ``"ok"``."""
        out, self._last = self._last, "ok"
        return out

    # -- observation (called by the Executor) ------------------------------
    def on_step(self, exe, program, step: int, sentry_vals,
                fetch_names, fetches) -> None:
        if self.sync:
            self._judge(exe, program, step, sentry_vals, fetch_names,
                        fetches, self._batch)
            return
        # deferred mode: judge the PREVIOUS step (its arrays are ready
        # by now — the next dispatch is already queued), keep this one.
        # The in-flight batch id is captured NOW: by the time the
        # deferred judgment runs, note_batch has already named the
        # NEXT step's batch, and quarantine must blame the one that
        # actually ran
        prev, self._pending = self._pending, (exe, program, step,
                                              sentry_vals, fetch_names,
                                              fetches, self._batch)
        if prev is not None:
            self._judge(*prev)

    def flush(self) -> None:
        """Judge a deferred (``sync=False``) step now — call at loop
        boundaries so the last step's verdict is never lost."""
        prev, self._pending = self._pending, None
        if prev is not None:
            self._judge(*prev)

    def _loss_of(self, fetch_names, fetches) -> Optional[float]:
        for name, val in zip(fetch_names, fetches):
            if self.loss_name is not None and name != self.loss_name:
                continue
            arr = _host(val)
            if arr.size == 1:
                return float(arr.reshape(()))
        return None

    def _judge(self, exe, program, step, sentry_vals, fetch_names,
               fetches, batch=None) -> None:
        flag, nf, extra, norm2 = (_host(v) for v in sentry_vals)
        anomalous = bool(flag)
        detail = {"step": int(step)}
        if anomalous:
            nf = nf.reshape(-1)
            for i, c in enumerate(nf):
                if int(c):
                    monitor.stat_add(f"anomaly.bucket.{i}.nonfinite",
                                     int(c))
            if int(extra):
                monitor.stat_add("grad_comm.nonfinite_blocks",
                                 int(extra))
            detail.update(kind="nonfinite",
                          nonfinite=int(nf.sum()) + int(extra))
        else:
            g = float(norm2)
            if np.isfinite(g):
                monitor.stat_set("anomaly.grad_norm", float(np.sqrt(g)))
            loss = self._loss_of(fetch_names, fetches)
            if loss is not None and self.spike_factor > 0:
                med = (float(np.median(self._losses))
                       if self._losses else None)
                if med is not None and np.isfinite(loss) \
                        and abs(loss) > self.spike_factor * max(
                            abs(med), 1e-12):
                    # finite corruption (bitflip-class): the update was
                    # already APPLIED — skip can't undo it, but the
                    # ladder's retry/quarantine/rollback rungs can
                    anomalous = True
                    self.loss_spikes += 1
                    monitor.stat_add("anomaly.loss_spikes")
                    detail.update(kind="loss_spike", loss=loss,
                                  median=med)
                else:
                    self._losses.append(loss)
        if not anomalous:
            self._consecutive = 0
            return
        self._consecutive += 1
        detail["consecutive"] = self._consecutive
        detail["batch"] = batch
        if self._consecutive <= self.skip_budget:
            self._decide("skip", detail)
        elif self._consecutive == self.skip_budget + 1:
            self._quarantine(detail, batch)
        else:
            self._rollback_or_give_up(exe, program, detail)

    # -- ladder rungs ------------------------------------------------------
    def _emit(self, action: str, detail: dict) -> None:
        trc = obs_hook._tracer
        if trc is not None:
            trc.emit("anomaly", action, args=detail)

    def _decide(self, action: str, detail: dict) -> None:
        self._last = action
        self.history.append(dict(detail, action=action))
        if action == "skip":
            self.skips += 1
            monitor.stat_add("anomaly.skips")
        self._emit(action, detail)

    def _quarantine(self, detail: dict, batch) -> None:
        entry = {"batch": batch, "step": detail["step"],
                 "skips": self._consecutive - 1}
        self.ledger.append(entry)
        self.quarantined.add(batch)
        monitor.stat_add("anomaly.quarantines")
        self._decide("quarantine", dict(detail, blamed=batch))

    def _rollback_or_give_up(self, exe, program, detail: dict) -> None:
        if self.store is not None \
                and self.rollbacks < self.rollback_budget:
            start_epoch = self.store.restore(self.objects)
            if self.store.last_restored is None:
                # the store has never published a snapshot: restore()
                # was a no-op, and "rolling back" would just replay
                # batches onto the live (possibly poisoned) weights —
                # that is a give-up, not a rollback
                monitor.stat_add("anomaly.giveups")
                self._decide("give_up", detail)
                raise AnomalyEscalation(
                    f"anomaly policy giving up at step "
                    f"{detail['step']}: rollback requested but the "
                    f"snapshot store has no published snapshot to "
                    f"restore", self.ledger, self.history)
            snap = dict(self.store.last_restored or {})
            self.resume_step = int(snap.get("step") or 0)
            self.rollbacks += 1
            self.data_seed += 1           # re-seeded data order
            self.quarantined.clear()      # fresh timeline
            self._consecutive = 0
            self._losses.clear()
            monitor.stat_add("anomaly.rollbacks")
            info = dict(detail, snapshot=snap.get("dir"),
                        resume_step=self.resume_step,
                        epoch=start_epoch, data_seed=self.data_seed)
            self._decide("rollback", info)
            # auditable post-mortem: annotate the flight recorder with
            # the rollback decision + blame ledger (best-effort — the
            # rollback itself must never die on observability)
            try:
                from ..observability.flight import (dump_flight,
                                                    flight_recorder_path)
                if flight_recorder_path() is not None:
                    dump_flight(reason="anomaly.rollback", extra={
                        "anomaly": info, "ledger": self.ledger,
                        "history": self.history[-16:],
                        "skips": self.skips,
                        "rollbacks": self.rollbacks,
                    })
            except Exception:  # noqa: BLE001
                pass
            if self.on_rollback is not None:
                self.on_rollback(snap)
            return
        monitor.stat_add("anomaly.giveups")
        self._decide("give_up", detail)
        raise AnomalyEscalation(
            f"anomaly policy giving up at step {detail['step']}: "
            f"{self._consecutive} consecutive anomalous steps after "
            f"{self.rollbacks} rollback(s) (budget "
            f"{self.rollback_budget}) and {len(self.ledger)} "
            f"quarantined batch(es) — handing off to supervisor "
            f"restart", self.ledger, self.history)

    def result(self) -> dict:
        """Summary for gates/drills: counts + ledger."""
        return {
            "skips": self.skips,
            "quarantines": len(self.ledger),
            "rollbacks": self.rollbacks,
            "loss_spikes": self.loss_spikes,
            "ledger": list(self.ledger),
            "resume_step": self.resume_step,
            "data_seed": self.data_seed,
        }
