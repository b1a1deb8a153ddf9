"""Zero-downtime weight hot swap: SnapshotStore -> serving engines (the
counterpart of ``paddle_tpu/serving/hotswap.py``).

The producer side is :class:`~..utils.checkpoint.SnapshotStore`
(digest-verified, atomically published snapshots).  This module is the
consumer side:

- :func:`publish_weights` packages serving payloads into a store
  snapshot: ``serving_artifact`` (the port's ``jit.save`` files as
  uint8 arrays — the :class:`~..inference.Predictor` runs the saved
  program with the saved weights, so new inference weights are a new
  artifact) and/or ``serving_params`` (a flat name->array dict for
  :meth:`GenerationEngine.swap_weights`).
- :class:`WeightWatcher` polls ``store.latest_snapshot()`` (one meta
  read — no payload I/O) and, on a new version: loads and
  sha256-verifies the payloads, builds and prewarms a replacement
  predictor (``InferenceEngine.prewarm_predictor``), uploads the
  generation parameters — all off the dispatch threads — then commits
  both engines at their batch/step boundaries (``swap_predictor``,
  ``swap_weights``).  In-flight work finishes on the old weights;
  nothing drains, no variant is added.  The prewarm runs on the card
  from the watcher's thread, on the same stream as live batches.

Failure semantics (paddle_tpu's):

- a corrupt or partial snapshot is **rejected** before anything is
  applied (``serving.swap.rejected``) and pinned so it is not retried;
  so is an artifact the port cannot load — one of paddle_tpu's JAX
  format is refused with ``jit.load``'s message naming both formats;
- a failure applying to the second engine after the first committed
  **rolls back** the first (``serving.swap.rolled_back``) — the
  replica never serves two versions across engines;
- a clean commit counts ``serving.swap.applied`` and advances
  ``weights_version`` everywhere it is surfaced (``/healthz``, engine
  stats, compile records, Prometheus).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core import obs_hook
from ..utils import monitor

__all__ = ["WeightWatcher", "publish_weights",
           "ARTIFACT_PAYLOAD", "PARAMS_PAYLOAD"]

ARTIFACT_PAYLOAD = "serving_artifact"   # jit.save files (uint8 arrays)
PARAMS_PAYLOAD = "serving_params"       # flat name -> array dict


class _StateDict:
    """Adapter: a plain dict as a SnapshotStore-savable object (the
    store's encode path requires ``state_dict()``)."""

    def __init__(self, d: Dict[str, object]):
        self._d = dict(d)

    def state_dict(self) -> Dict[str, object]:
        return self._d


def _host(v) -> np.ndarray:
    """A parameter (numpy array or tensor, on any device) as numpy."""
    if isinstance(v, torch.Tensor):
        return torch.Tensor.numpy(v.detach().cpu())
    return np.asarray(v)


def _read_bytes(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype=np.uint8)


def publish_weights(store, version: int,
                    artifact_prefix: Optional[str] = None,
                    params: Optional[Dict[str, object]] = None,
                    extra_suffixes: Sequence[str] = (".pdiparams",)
                    ) -> dict:
    """Publish one serving-weights snapshot (synchronous, digested).

    ``artifact_prefix`` — a ``jit.save`` output prefix; its
    ``.pdmodel`` bytes (plus any ``extra_suffixes`` sidecars that
    exist) ride the snapshot as uint8 arrays under
    ``serving_artifact``.  ``params`` — a flat name->array dict under
    ``serving_params``.  Returns the published meta entry."""
    objects = {}
    if artifact_prefix is not None:
        blobs = {"pdmodel": _read_bytes(artifact_prefix + ".pdmodel")}
        for suf in extra_suffixes:
            p = artifact_prefix + suf
            if os.path.exists(p):
                blobs[suf.lstrip(".")] = _read_bytes(p)
        objects[ARTIFACT_PAYLOAD] = _StateDict(blobs)
    if params is not None:
        objects[PARAMS_PAYLOAD] = _StateDict(
            {k: _host(v) for k, v in params.items()})
    if not objects:
        raise ValueError("publish_weights needs an artifact_prefix "
                         "and/or params")
    store.save(0, objects, step=int(version), kind="step")
    return store.latest_snapshot()


class WeightWatcher:
    """Polls a :class:`SnapshotStore` and hot-swaps serving weights.

    Args:
        store: the snapshot store to watch (or its directory path).
        engine: an :class:`InferenceEngine` fed by ``serving_artifact``
            payloads (may be None).
        generation: a :class:`GenerationEngine` fed by
            ``serving_params`` payloads (may be None).
        poll_s: meta-poll cadence of the background thread.
        rest_shapes: forwarded to
            :meth:`InferenceEngine.prewarm_predictor` when the artifact
            metadata lacks static shapes.

    Use :meth:`start`/:meth:`stop` for the background loop, or call
    :meth:`check_once` directly for deterministic (test) driving —
    both run the entire load/verify/build/prewarm pipeline on the
    calling/watcher thread, never on an engine's dispatch thread.
    """

    def __init__(self, store, engine=None, generation=None,
                 poll_s: float = 1.0,
                 rest_shapes: Optional[Sequence[Sequence[int]]] = None):
        if isinstance(store, str):
            from ..utils.checkpoint import SnapshotStore
            store = SnapshotStore(store)
        if engine is None and generation is None:
            raise ValueError("WeightWatcher needs at least one engine")
        self.store = store
        self.engine = engine
        self.generation = generation
        self.poll_s = float(poll_s)
        self._rest_shapes = rest_shapes
        self.version = 0                    # last applied
        self.last_rejected: Optional[int] = None
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "WeightWatcher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="weight-watcher", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_once()
            except Exception as e:      # a broken store must not kill
                self.last_error = f"{type(e).__name__}: {e}"
                monitor.stat_add("serving.swap.errors")

    # -- the swap pipeline -------------------------------------------------
    def _emit(self, name: str, **args) -> None:
        trc = obs_hook._tracer
        if trc is not None:
            trc.emit("serving", name, args=args)

    def _reject(self, version: int, why: str) -> None:
        self.last_rejected = version
        self.last_error = why
        monitor.stat_add("serving.swap.rejected")
        self._emit("swap_rejected", version=version, why=why)
        warnings.warn(f"weight swap of version {version} rejected: "
                      f"{why}; still serving version {self.version}")

    def _build_predictor(self, blobs: Dict[str, object]):
        """Artifact bytes -> a loaded, bucket-prewarmed Predictor (not
        yet serving — prewarm runs every bucket so the later commit
        adds no variant)."""
        from ..inference import Config, create_predictor
        tmp = tempfile.mkdtemp(prefix="hotswap_")
        try:
            for name, arr in blobs.items():
                suffix = "pdmodel" if name == "pdmodel" else name
                with open(os.path.join(tmp, f"model.{suffix}"), "wb") \
                        as f:
                    f.write(np.ascontiguousarray(arr, dtype=np.uint8).data)
            pred = create_predictor(Config(os.path.join(tmp, "model")))
            self.engine.prewarm_predictor(pred, self._rest_shapes)
            return pred
        finally:
            # the artifact is fully resident after load; the temp files
            # are only a transport format
            shutil.rmtree(tmp, ignore_errors=True)

    def check_once(self) -> Optional[int]:
        """One poll: returns the newly applied version, or None (no new
        snapshot / rejected).  Safe to call concurrently with traffic —
        everything heavy happens off the dispatch threads."""
        snap = self.store.latest_snapshot()
        if snap is None:
            return None
        version = int(snap.get("step") or snap.get("epoch") or 0)
        if version <= self.version or version == self.last_rejected:
            return None
        digests = snap.get("digests") or {}
        wanted = []
        if self.engine is not None \
                and f"{ARTIFACT_PAYLOAD}.pdparams" in digests:
            wanted.append(ARTIFACT_PAYLOAD)
        if self.generation is not None \
                and f"{PARAMS_PAYLOAD}.pdparams" in digests:
            wanted.append(PARAMS_PAYLOAD)
        if not wanted:      # not a serving snapshot (e.g. a training
            return None     # checkpoint sharing the store): skip quietly
        expected = [ARTIFACT_PAYLOAD] * (self.engine is not None) \
            + [PARAMS_PAYLOAD] * (self.generation is not None)
        if wanted != expected:
            self._reject(version,
                         f"partial snapshot: has {wanted}, replica "
                         f"serves engines needing {expected}")
            return None
        payloads = self.store.load_payloads(wanted, snap)
        if payloads is None:    # digest mismatch / missing / undecodable
            self._reject(version, "payload failed digest verification")
            return None

        # build + prewarm everything BEFORE committing anything
        pred = None
        if self.engine is not None:
            try:
                pred = self._build_predictor(payloads[ARTIFACT_PAYLOAD])
            except Exception as e:
                self._reject(version, f"artifact rejected: "
                             f"{type(e).__name__}: {e}")
                return None

        old_pred = old_version = None
        if pred is not None:
            old_version = self.engine.weights_version
            old_pred = self.engine.swap_predictor(pred, version)
        if self.generation is not None:
            try:
                self.generation.swap_weights(
                    payloads[PARAMS_PAYLOAD], version)
            except Exception as e:
                if old_pred is not None:
                    # the replica must never serve two versions: undo
                    # the inference commit (the old predictor is still
                    # warm — this swap adds no variant either)
                    self.engine.swap_predictor(old_pred, old_version)
                    monitor.stat_add("serving.swap.rolled_back")
                    self._emit("swap_rolled_back", version=version,
                               restored=old_version)
                self._reject(version, f"generation apply failed: "
                             f"{type(e).__name__}: {e}")
                return None
        self.version = version
        self.last_error = None
        monitor.stat_add("serving.swap.applied")
        self._emit("swap_applied", version=version)
        return version
