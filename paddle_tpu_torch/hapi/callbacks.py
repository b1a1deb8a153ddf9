"""Training callbacks for ``Model.fit`` (the counterpart of
``paddle_tpu/hapi/callbacks.py``; reference:
python/paddle/hapi/callbacks.py): ProgBarLogger, ModelCheckpoint,
Checkpoint (a digest-verified ``utils.checkpoint.SnapshotStore`` with the
SIGTERM preemption save), MetricsDump (``observability.dump_metrics``),
EarlyStopping, LRScheduler, ReduceLROnPlateau and VisualDL (scalars as
JSON lines)."""
from __future__ import annotations

import os
import time

import numpy as np


def _lr_scheduler(opt):
    """The optimizer's LRScheduler, or None (a constant rate)."""
    from ..optimizer.lr import LRScheduler as _Sched
    lr = getattr(opt, "_learning_rate", None)
    return lr if isinstance(lr, _Sched) else None


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    # always invoked by Model.fit (finally:), even when training raises
    # — release process-wide resources (signal handlers, files) here
    def on_train_cleanup(self): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def _dispatch(*args, **kw):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kw)
            return _dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """reference: hapi/callbacks.py ProgBarLogger."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(
                f"{k}: {np.asarray(v).item() if hasattr(v, 'item') else v:.4f}"
                if isinstance(v, (int, float, np.floating)) else f"{k}: {v}"
                for k, v in logs.items())
            print(f"step {step + 1}/{self.steps or '?'} - {items}")

    def on_eval_end(self, logs=None):
        if self.verbose and logs:
            items = " - ".join(f"{k}: {v}" for k, v in logs.items())
            print(f"Eval - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class Checkpoint(Callback):
    """Fault-tolerant checkpointing for ``Model.fit`` — the
    utils.checkpoint robustness knobs surfaced as a callback.

    Every ``save_freq`` epochs the network (and optimizer, when
    prepared) snapshot into ``save_dir`` with per-file sha256 digests,
    rotated to the last ``keep_checkpoint_max`` snapshots.  On train
    begin the newest snapshot that VERIFIES is restored (corrupt ones
    fall back to the previous intact snapshot), so a preempted
    ``fit()`` continues from published weights instead of from scratch.
    While training, SIGTERM — a preemption notice —
    requests a snapshot at the next epoch boundary and then stops
    training cleanly (``model.stop_training``); ``self.preempted``
    records that this happened.  Note: ``fit`` restarts its epoch
    counter — for exact epoch-resume loops use
    ``utils.checkpoint.TrainEpochRange``."""

    def __init__(self, save_dir, save_freq=1, keep_checkpoint_max=None,
                 verify=True, restore=True, handle_preemption=True):
        super().__init__()
        self.save_dir = save_dir
        self.save_freq = max(1, int(save_freq))
        self.keep_checkpoint_max = keep_checkpoint_max
        self.verify = verify
        self.restore = restore
        self.handle_preemption = handle_preemption
        self.preempted = False
        self.last_restored_epoch = None
        self._store = None
        self._restore_handler = None

    def _objects(self):
        objs = {"model": self.model.network}
        if getattr(self.model, "_optimizer", None) is not None:
            objs["optimizer"] = self.model._optimizer
        return objs

    def _on_preempt(self):
        self.preempted = True

    def on_train_begin(self, logs=None):
        from ..utils.checkpoint import (SnapshotStore,
                                        install_preemption_handler)
        self._store = SnapshotStore(self.save_dir,
                                    keep_max=self.keep_checkpoint_max,
                                    verify=self.verify)
        self.preempted = False
        if self.restore:
            # restore() returns 0 when no checkpoint is published yet
            resumed = self._store.restore(self._objects())
            self.last_restored_epoch = resumed - 1 if resumed else None
        if self.handle_preemption:
            self._restore_handler = \
                install_preemption_handler(self._on_preempt)

    def on_epoch_end(self, epoch, logs=None):
        if self.preempted or (epoch + 1) % self.save_freq == 0:
            self._store.save(epoch, self._objects())
        if self.preempted:
            from ..utils import monitor
            monitor.stat_add("checkpoint.preempt_saves")
            self.model.stop_training = True

    def on_train_cleanup(self):
        if self._restore_handler is not None:
            self._restore_handler()
            self._restore_handler = None

    def on_train_end(self, logs=None):
        self.on_train_cleanup()


class MetricsDump(Callback):
    """Append monitor-metrics snapshots (stats + histograms) as JSONL
    while ``Model.fit`` runs — the training-side feed of the unified
    metrics exporter (``observability.dump_metrics``).

    One line per ``save_freq`` epochs plus one at train end; each line
    is a full ``observability.metrics_snapshot`` tagged with the epoch.
    ``path`` defaults to ``FLAGS_metrics_dump_path``; when that flag is
    set, ``Model.fit`` attaches this callback automatically."""

    def __init__(self, path=None, save_freq=1):
        super().__init__()
        self.path = path
        self.save_freq = max(1, int(save_freq))

    def _dump(self, tag, extra=None):
        from ..core.flags import get_flag
        path = self.path or get_flag("metrics_dump_path")
        if not path:
            return
        from ..observability import dump_metrics
        dump_metrics(path, extra={"tag": tag, **(extra or {})})

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % self.save_freq == 0:
            self._dump("epoch_end", {"epoch": epoch})

    def on_train_end(self, logs=None):
        self._dump("train_end")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode
        self.best = None

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = logs[self.monitor]
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        cur = float(np.asarray(cur))
        improved = (self.best is None or
                    (cur < self.best - self.min_delta
                     if self.mode == "min"
                     else cur > self.best + self.min_delta))
        if improved:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference: hapi LRScheduler cb)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        return _lr_scheduler(getattr(self.model, "_optimizer", None))

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class ReduceLROnPlateau(Callback):
    """Reduce lr when a monitored metric stops improving (reference:
    hapi/callbacks.py ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="min", min_delta=1e-4, cooldown=0,
                 min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._best = None
        self._wait = 0
        self._cool = 0
        self._saw_eval = False

    def _better(self, cur):
        if self._best is None:
            return True
        if self.mode == "min":
            return cur < self._best - self.min_delta
        return cur > self._best + self.min_delta

    # check ONCE per epoch: eval logs when evaluation runs, else train
    # logs (the reference checks a single monitored stream)
    def on_eval_end(self, logs=None):
        self._saw_eval = True
        self._check(logs)

    def on_epoch_end(self, epoch, logs=None):
        if not self._saw_eval:
            self._check(logs)

    def _check(self, logs):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._better(cur):
            self._best = cur
            self._wait = 0
            return
        if self._cool > 0:
            self._cool -= 1
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                sched = _lr_scheduler(opt)
                if sched is not None:
                    import warnings
                    warnings.warn(
                        "ReduceLROnPlateau callback skipped: the "
                        "optimizer drives an LRScheduler; use "
                        "optimizer.lr.ReduceOnPlateau as the scheduler "
                        "instead")
                else:
                    old = float(opt.get_lr())
                    new = max(old * self.factor, self.min_lr)
                    if new < old:
                        opt._learning_rate = new
                        if self.verbose:
                            print(f"ReduceLROnPlateau: lr {old:g} -> "
                                  f"{new:g}")
            self._wait = 0
            self._cool = self.cooldown


class VisualDL(Callback):
    """Scalar logger (reference: hapi VisualDL callback): scalars append
    to ``<log_dir>/scalars.jsonl``, readable by any dashboard."""

    def __init__(self, log_dir="./vdl_log"):
        super().__init__()
        import os
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, "scalars.jsonl")
        self._step = 0

    def _write(self, tag, logs):
        import json
        logs = logs or {}
        rows = []
        for k, v in logs.items():
            try:
                v = float(v[0] if isinstance(v, (list, tuple)) else v)
            except (TypeError, ValueError):
                continue
            rows.append({"tag": f"{tag}/{k}", "step": self._step,
                         "value": v})
        if rows:
            with open(self._path, "a") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     verbose=2, metrics=None):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    from ..core.flags import get_flag
    if get_flag("metrics_dump_path") and not any(
            isinstance(c, MetricsDump) for c in cbks):
        cbks.append(MetricsDump())
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                   "metrics": metrics or []})
    return cl
