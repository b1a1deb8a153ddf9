"""Dynamic-batching inference engine over the port's Predictor, and the
errors and helpers both serving engines share (the counterpart of
``paddle_tpu/serving/engine.py``).

- Callers enqueue requests (``infer`` returns a
  :class:`concurrent.futures.Future`); one dispatcher thread pops
  waiting requests, coalesces them into one batch of at most
  ``max_batch_size`` rows, pads the batch dimension up to the smallest
  declared bucket, and runs the Predictor once for the whole batch.
  :meth:`InferenceEngine.warmup` runs every bucket first, so the serve
  path meets no input signature the Predictor has not prepared
  (``recompiles_after_warmup`` stays 0).
- A bounded queue sheds load when full (:class:`QueueFull`),
  per-request deadlines expire in the queue without taking a batch
  slot (:class:`DeadlineExceeded`), a failed dispatch is retried
  (inference is pure), and ``drain()`` / ``close()`` finish in-flight
  work and never strand a future.
- ``fault.point("serving.enqueue")`` / ``fault.point("serving.dispatch")``
  let tests flake admission and dispatch deterministically.
- :meth:`InferenceEngine.swap_predictor` commits a prepared
  replacement predictor under the engine's lock at a batch boundary.

The dispatcher thread calls ``Predictor.run``, which runs the saved
program under ``torch.no_grad`` itself (grad mode is per thread), on
the Predictor's device.  Its outputs are read to the host once a batch
(``np.asarray`` on each output: one device-to-host copy an output), and
every future resolves to numpy arrays of its own.  The hand kernels'
launch counters (``ops.cuda.support.launch_counts``) are process-wide,
so the dispatcher's launches count like any other.

The generative engine (:mod:`.generation`) uses the error types and the
``_safe_set_*`` / ``_mirrored_*`` helpers below.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core import flags, obs_hook
from ..testing import fault
from ..utils import monitor

__all__ = ["InferenceEngine", "ServingError", "QueueFull",
           "DeadlineExceeded", "EngineClosed"]


class ServingError(RuntimeError):
    """Base class for engine-raised request failures."""


class QueueFull(ServingError):
    """Load shed: the bounded request queue was full at admission."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired while it waited or decoded."""


class EngineClosed(ServingError):
    """The engine is draining or closed; no new requests are accepted."""


_REQUEST_IDS = itertools.count(1)   # process-wide request correlation ids


def _safe_set_result(fut: Future, value) -> None:
    try:
        fut.set_result(value)
    except Exception:       # cancelled by the caller: nothing to deliver
        pass


def _safe_set_exception(fut: Future, exc: BaseException) -> None:
    try:
        fut.set_exception(exc)
    except Exception:
        pass


def _mirrored_add(base: str, prefix, suffix: str, v=1) -> None:
    """One engine counter: the process aggregate under ``base`` plus
    the per-engine mirror under ``prefix`` when the engine is named."""
    monitor.stat_add(base + suffix, v)
    if prefix is not None:
        monitor.stat_add(prefix + suffix, v)


def _mirrored_observe(base: str, prefix, suffix: str, v) -> None:
    monitor.stat_observe(base + suffix, v)
    if prefix is not None:
        monitor.stat_observe(prefix + suffix, v)


class _Request:
    __slots__ = ("arrays", "rows", "future", "deadline", "t_enq", "rid",
                 "trace")

    def __init__(self, arrays, rows, deadline):
        self.arrays = arrays
        self.rows = rows
        self.future: Future = Future()
        self.deadline = deadline            # monotonic seconds, or None
        self.t_enq = time.monotonic()
        self.rid = next(_REQUEST_IDS)
        self.trace: Optional[str] = None    # distributed trace id, if the
                                            # admitting thread carried one


class InferenceEngine:
    """Dynamic-batching front for a
    :class:`paddle_tpu_torch.inference.Predictor`.

    Args:
        predictor: a loaded Predictor (the engine becomes its only
            caller; the Predictor itself is single-threaded).
        max_batch_size: coalesced-batch row capacity; also the largest
            admissible request.
        batch_timeout_ms: how long the dispatcher waits for more
            requests after the first one arrives before launching a
            partial batch.
        max_queue: bounded queue capacity (requests, not rows); a full
            queue sheds new arrivals with :class:`QueueFull`.
        default_deadline_ms: in-queue deadline applied to requests that
            don't carry their own (None = wait forever).
        buckets: batch capacities to pad to, e.g. ``[1, 2, 4, 8]``;
            default powers of two up to ``max_batch_size``.  ``warmup``
            runs exactly these shapes once.
        dispatch_retries: re-runs of a failed batch before its requests
            are failed (default ``FLAGS_serving_dispatch_retries``).
        name: engine label for multi-model processes.  When set, the
            engine's monitor stats mirror under
            ``serving.engine.<name>.*`` (in addition to the process
            aggregate ``serving.*``) and tracer events carry it.
    """

    def __init__(self, predictor, max_batch_size: int = 32,
                 batch_timeout_ms: float = 2.0, max_queue: int = 256,
                 default_deadline_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 dispatch_retries: Optional[int] = None,
                 name: Optional[str] = None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._pred = predictor
        self.name = str(name) if name else None
        self._stat_prefix = (f"serving.engine.{self.name}."
                             if self.name else None)
        self._input_names = list(predictor.get_input_names())
        meta = getattr(predictor, "_meta", {}) or {}
        self._in_dtypes = [np.dtype(d) for d in meta.get("in_dtypes", [])] \
            or None
        self._in_shapes = meta.get("in_shapes")
        # non-batch dims per input, when the artifact declares them
        # statically — lets admission reject a mis-shaped request instead
        # of letting it poison a coalesced batch
        self._rest_shapes: Optional[List[tuple]] = None
        if self._in_shapes:
            try:
                self._rest_shapes = [tuple(int(d) for d in s[1:])
                                     for s in self._in_shapes]
            except (TypeError, ValueError):
                pass    # symbolic non-batch dims: the program checks them
        self._max_batch = int(max_batch_size)
        self._batch_timeout = max(0.0, float(batch_timeout_ms)) / 1000.0
        self._max_queue = int(max_queue)
        self._default_deadline = (float(default_deadline_ms) / 1000.0
                                  if default_deadline_ms is not None
                                  else None)
        self._retries = (flags.get_flag("serving_dispatch_retries")
                         if dispatch_retries is None
                         else int(dispatch_retries))
        if buckets is None:
            buckets = []
            b = 1
            while b < self._max_batch:
                buckets.append(b)
                b <<= 1
            buckets.append(self._max_batch)
        self._buckets = sorted(set(int(b) for b in buckets))
        if not self._buckets or self._buckets[0] < 1:
            raise ValueError("buckets must be positive")
        if self._buckets[-1] > self._max_batch:
            raise ValueError(
                f"bucket {self._buckets[-1]} exceeds max_batch_size="
                f"{self._max_batch}; it could never fill and every "
                f"batch would pad past the declared row capacity")
        if self._buckets[-1] < self._max_batch:
            self._buckets.append(self._max_batch)

        self._cv = threading.Condition(threading.Lock())
        self._queue: collections.deque = collections.deque()
        self._queued_rows = 0
        self._queued_deadlines = 0      # requests in queue with a deadline
        self._inflight = False
        self._inflight_reqs: List[_Request] = []
        self._draining = False
        self._closing = False
        self._closed = False
        self._paused = False            # testing hook: pause()/resume()
        self._pred_mu = threading.Lock()
        self._warm_variants: Optional[int] = None
        self._weights_version = 0       # last hot-swapped snapshot step
        # which outputs carry the batch dim: warmup observes it across
        # bucket sizes; the artifact's symbolic out_avals are the
        # fallback; None = per-batch shape heuristic
        self._out_mask: Optional[List[bool]] = getattr(
            predictor, "batched_output_mask", lambda: None)()
        self._c: Dict[str, Union[int, float]] = collections.defaultdict(int)
        self._occ_sum = 0.0
        # per-engine histogram registry: two engines in one process (or
        # a monitor.stat_reset() in a test) must not cross-contaminate
        # /metrics latency percentiles; global monitor mirrors remain
        self._reg = monitor.StatRegistry()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="serving-dispatcher",
                                        daemon=True)
        self._thread.start()

    # -- per-engine metrics ------------------------------------------------
    def _madd(self, suffix: str, v=1) -> None:
        """Count ``serving.<suffix>`` — and mirror it under this
        engine's ``serving.engine.<name>.`` prefix when labelled, so a
        multi-model process can tell its engines apart."""
        _mirrored_add("serving.", self._stat_prefix, suffix, v)

    def _mobs(self, suffix: str, v) -> None:
        _mirrored_observe("serving.", self._stat_prefix, suffix, v)

    def _ev(self, **args) -> dict:
        """Tracer event args, engine-labelled when the engine is."""
        if self.name is not None:
            args["engine"] = self.name
        return args

    # -- admission ---------------------------------------------------------
    def _normalize(self, inputs) -> List[np.ndarray]:
        if isinstance(inputs, dict):
            try:
                inputs = [inputs[n] for n in self._input_names]
            except KeyError as e:
                raise ValueError(f"missing input {e.args[0]!r}; expected "
                                 f"{self._input_names}") from None
        elif isinstance(inputs, np.ndarray) or not isinstance(
                inputs, (list, tuple)):
            inputs = [inputs]
        if len(inputs) != len(self._input_names):
            raise ValueError(f"expected {len(self._input_names)} inputs "
                             f"{self._input_names}, got {len(inputs)}")
        arrays = []
        for i, a in enumerate(inputs):
            dt = self._in_dtypes[i] if self._in_dtypes else None
            arrays.append(np.asarray(a, dtype=dt))
        rows = {a.shape[0] for a in arrays if a.ndim >= 1}
        if len(rows) != 1 or any(a.ndim < 1 for a in arrays):
            raise ValueError(
                "every input must carry a shared leading batch dim; got "
                f"shapes {[a.shape for a in arrays]}")
        n = rows.pop()
        if self._rest_shapes is not None:
            for a, rest, name in zip(arrays, self._rest_shapes,
                                     self._input_names):
                if a.shape[1:] != rest:
                    raise ValueError(
                        f"input {name!r} has per-row shape "
                        f"{tuple(a.shape[1:])}, expected {rest}")
        if n < 1:
            raise ValueError("empty request (leading dim 0)")
        if n > self._max_batch:
            raise ValueError(
                f"request of {n} rows exceeds max_batch_size="
                f"{self._max_batch}; split it client-side")
        return arrays

    def infer(self, inputs, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the output
        list (host numpy arrays, leading dim = the request's rows).

        Raises :class:`QueueFull` (shed), :class:`EngineClosed`, or
        ``ValueError`` (malformed request) synchronously.
        """
        arrays = self._normalize(inputs)
        n = arrays[0].shape[0]
        fault.point("serving.enqueue", f"rows={n}")
        deadline = None
        dl_s = (float(deadline_ms) / 1000.0 if deadline_ms is not None
                else self._default_deadline)
        if dl_s is not None:
            deadline = time.monotonic() + dl_s
        req = _Request(arrays, n, deadline)
        with self._cv:
            if self._closing or self._closed or self._draining:
                raise EngineClosed("engine is draining or closed")
            if len(self._queue) >= self._max_queue:
                # dead slots must not shed live traffic: requests whose
                # deadline lapsed while the dispatcher was mid-batch
                # still sit in the queue until the next sweep — sweep
                # here (lock already held) before deciding to shed
                self._expire_locked()
            if len(self._queue) >= self._max_queue:
                self._c["shed"] += 1
                self._madd("shed")
                trc = obs_hook._tracer
                if trc is not None:
                    trc.emit("serving", "shed",
                             args=self._ev(rid=req.rid, rows=n))
                raise QueueFull(
                    f"queue full ({self._max_queue} requests); retry with "
                    f"backoff")
            self._queue.append(req)
            self._queued_rows += req.rows
            if req.deadline is not None:
                self._queued_deadlines += 1
            self._c["requests"] += 1
            self._madd("requests")
            self._cv.notify_all()
        trc = obs_hook._tracer
        if trc is not None:
            # the admitting thread's distributed trace context (bound by
            # the HTTP front-end) sticks to the request so the scheduler
            # thread's dispatch event can carry it too
            req.trace = trc.current_trace()
            trc.emit("serving", "enqueue",
                     args=self._ev(rid=req.rid, rows=n))
        return req.future

    def infer_sync(self, inputs, deadline_ms: Optional[float] = None,
                   timeout: Optional[float] = None):
        """Blocking :meth:`infer`; returns the output list."""
        return self.infer(inputs, deadline_ms=deadline_ms).result(timeout)

    # -- dispatcher --------------------------------------------------------
    def _expire_one_locked(self, r: _Request, now: float) -> None:
        self._queued_rows -= r.rows
        self._queued_deadlines -= 1
        self._c["deadline_expired"] += 1
        self._madd("deadline_expired")
        trc = obs_hook._tracer
        if trc is not None:
            trc.emit("serving", "deadline_expired",
                     args=self._ev(rid=r.rid,
                                   waited_ms=(now - r.t_enq) * 1000.0))
        _safe_set_exception(r.future, DeadlineExceeded(
            f"deadline expired after "
            f"{(now - r.t_enq) * 1000:.1f} ms in queue"))

    def _expire_locked(self) -> None:
        """Drop queued requests whose deadline has passed (they never
        occupy a batch slot).  Caller holds the lock.  O(1) when no
        queued request carries a deadline — the steady-state hot path."""
        if not self._queue or not self._queued_deadlines:
            return
        now = time.monotonic()
        alive = collections.deque()
        for r in self._queue:
            if r.deadline is not None and now > r.deadline:
                self._expire_one_locked(r, now)
            else:
                alive.append(r)
        self._queue = alive

    def _next_batch(self) -> Optional[List[_Request]]:
        """Block until a batch is ready; None when closed and drained."""
        with self._cv:
            while True:
                self._expire_locked()
                if self._closing and not self._queue:
                    return None
                if self._queue and not self._paused:
                    break
                # timed wait only to sweep in-queue deadlines the
                # dispatcher can't pop (paused); every other state
                # change (enqueue/resume/close) notifies — an idle
                # engine sleeps instead of polling at 20 Hz
                self._cv.wait(0.05 if self._queued_deadlines else None)
            # Wait for the batch to fill.  The budget runs from the
            # OLDEST request's enqueue, not from now: time a request
            # already waited while the previous batch executed counts,
            # so a saturated engine dispatches back-to-back with zero
            # idle wait and batch_timeout_ms bounds per-request queue
            # delay, not per-batch fill time.
            t_full = self._queue[0].t_enq + self._batch_timeout
            while not (self._closing or self._draining or self._paused):
                self._expire_locked()
                if not self._queue:     # everything expired: start over
                    return []
                if self._queued_rows >= self._max_batch:
                    break
                now = time.monotonic()
                t_full = self._queue[0].t_enq + self._batch_timeout
                if now >= t_full:
                    break
                self._cv.wait(min(t_full - now, 0.05))
            if self._paused:
                return []
            batch: List[_Request] = []
            rows = 0
            now = time.monotonic()
            while self._queue:
                r = self._queue[0]
                if r.deadline is not None and now > r.deadline:
                    self._queue.popleft()
                    self._expire_one_locked(r, now)
                    continue
                if rows + r.rows > self._max_batch:
                    break
                self._queue.popleft()
                self._queued_rows -= r.rows
                if r.deadline is not None:
                    self._queued_deadlines -= 1
                batch.append(r)
                rows += r.rows
            if batch:
                self._inflight = True
                self._inflight_reqs = batch
            return batch

    def _bucket_for(self, rows: int) -> int:
        for b in self._buckets:
            if b >= rows:
                return b
        return self._buckets[-1]

    def _execute(self, batch: List[_Request]) -> None:
        rows = sum(r.rows for r in batch)
        target = self._bucket_for(rows)
        feeds = []
        for i in range(len(self._input_names)):
            a = np.concatenate([r.arrays[i] for r in batch], axis=0)
            if target > rows:
                pad = np.zeros((target - rows,) + a.shape[1:],
                               dtype=a.dtype)
                a = np.concatenate([a, pad], axis=0)
            feeds.append(a)
        last_exc: Optional[BaseException] = None
        outs = None
        t_disp = time.perf_counter()
        # perf observatory (one None-check when off): a sampled dispatch
        # times its device lane by CUDA events, start here and end
        # before the host read (which waits for it anyway)
        p = obs_hook._perf
        sample = (p.serving_begin(self.name, "dispatch",
                                  getattr(self._pred, "device", None))
                  if p is not None else None)
        for attempt in range(self._retries + 1):
            try:
                fault.point("serving.dispatch",
                            f"rows={rows}", f"attempt={attempt}")
                with self._pred_mu:
                    outs = self._pred.run(feeds)
                last_exc = None
                break
            except Exception as e:          # pure inference: retry whole
                last_exc = e                # batch on any dispatch fault
                self._c["dispatch_errors"] += 1
                self._madd("dispatch_errors")
                if attempt < self._retries:
                    self._c["dispatch_retries"] += 1
                    self._madd("dispatch_retries")
        if sample is not None:
            sample.stop()
        t_done = time.perf_counter()
        # supervised liveness: one beat per dispatched batch (success OR
        # failure — the signal is "the dispatch loop makes progress",
        # not "requests succeed"); a single None-check when unsupervised
        hb = obs_hook._heartbeat
        if hb is not None:
            hb.beat(int(self._c["batches"]) + 1)
        exp = obs_hook._export
        if exp is not None:
            exp.tick()
        trc = obs_hook._tracer
        if trc is not None:
            # one typed event per coalesced dispatch, correlated to the
            # member requests by id (and to their distributed traces,
            # when the admitting threads carried any)
            traces = sorted({r.trace for r in batch if r.trace})
            trc.emit("serving", "dispatch", ts=t_disp,
                     dur=t_done - t_disp,
                     args=self._ev(rids=[r.rid for r in batch],
                                   rows=rows, bucket=target,
                                   attempts=attempt + 1,
                                   ok=last_exc is None,
                                   **({"traces": traces} if traces
                                      else {})))
        if last_exc is not None:
            for r in batch:
                _safe_set_exception(r.future, last_exc)
            self._c["failed"] += len(batch)
            self._madd("failed", len(batch))
            return
        host = [np.asarray(o) for o in outs]    # one device sync per batch
        # per-engine dispatch anatomy, measured AFTER the host read
        # above: the outputs of a CUDA run are ready only once read, so
        # a stamp before it would time the launches instead of the batch
        if p is not None:
            p.serving_step(self.name, "dispatch",
                           time.perf_counter() - t_disp, sample)
        mask = self._out_mask
        batched = [h.ndim >= 1
                   and (mask[j] if mask is not None and j < len(mask)
                        else h.shape[0] == target)
                   for j, h in enumerate(host)]
        now = time.monotonic()
        # the counters move before any future resolves: a caller that
        # reads stats() after its answer sees its batch counted
        with self._cv:      # stats() snapshots under this lock; keep
            self._c["responses"] += len(batch)   # its view consistent
            self._c["batches"] += 1
            self._c["rows"] += rows
            self._c["padded_rows"] += target - rows
            self._occ_sum += rows / target
        off = 0
        for r in batch:
            # every request gets its OWN arrays (incl. non-batched
            # outputs): resolved futures must never alias each other
            res = [h[off:off + r.rows].copy() if b else h.copy()
                   for h, b in zip(host, batched)]
            off += r.rows
            _safe_set_result(r.future, res)
            lat_ms = (now - r.t_enq) * 1000.0
            self._reg.observe("latency_ms", lat_ms)
            self._mobs("latency_ms", lat_ms)
        self._madd("batches")
        self._madd("rows", rows)
        self._madd("padded_rows", target - rows)
        self._mobs("batch_occupancy", rows / target)
        self._mobs("requests_per_batch", len(batch))

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            if not batch:           # paused, or everything expired
                continue
            try:
                self._execute(batch)
            except Exception as e:  # defense in depth: the dispatcher
                # thread must survive ANYTHING (a dead dispatcher
                # strands every future); fail the batch cleanly instead
                for r in batch:
                    _safe_set_exception(r.future, e)
                self._c["failed"] += len(batch)
                self._madd("failed", len(batch))
            finally:
                with self._cv:
                    self._inflight = False
                    self._inflight_reqs = []
                    self._cv.notify_all()

    # -- warmup / lifecycle ------------------------------------------------
    def _bucket_feeds(self, rest_shapes: Optional[Sequence[Sequence[int]]]):
        """Yield ``(bucket, feeds)`` zero-feeds for every bucket —
        shared by :meth:`warmup` (this engine's predictor, under the
        engine lock) and :meth:`prewarm_predictor` (a replacement
        predictor, no lock needed: it is not serving yet)."""
        if rest_shapes is None:
            if self._in_shapes is None:
                raise ValueError("artifact metadata lacks input shapes; "
                                 "pass rest_shapes=[shape_without_batch,...]")
            try:
                rest_shapes = [tuple(int(d) for d in s[1:])
                               for s in self._in_shapes]
            except (TypeError, ValueError):
                raise ValueError(
                    "artifact has symbolic non-batch dims; pass concrete "
                    "rest_shapes=[shape_without_batch, ...]") from None
        dtypes = self._in_dtypes or [np.float32] * len(self._input_names)
        for b in self._buckets:
            yield b, [np.zeros((b,) + tuple(rs), dtype=dt)
                      for rs, dt in zip(rest_shapes, dtypes)]

    def warmup(self, rest_shapes: Optional[Sequence[Sequence[int]]] = None
               ) -> int:
        """Run every bucket once so the serve path meets only prepared
        input signatures.

        ``rest_shapes`` — per-input shapes *minus* the batch dim; derived
        from the artifact metadata when its non-batch dims are static.
        Returns the Predictor's variant count after warmup (the
        baseline for ``recompiles_after_warmup``)."""
        out_shapes = {}
        with self._pred_mu:
            for b, feeds in self._bucket_feeds(rest_shapes):
                outs = self._pred.run(feeds)
                out_shapes[b] = [tuple(np.shape(o)) for o in outs]
        if len(out_shapes) >= 2:
            # observed ground truth: an output carries the batch dim iff
            # its leading dim tracked the bucket size across warmup runs
            # (beats any shape-coincidence heuristic at serve time)
            n_out = min(len(s) for s in out_shapes.values())
            self._out_mask = [
                all(len(s[j]) >= 1 and s[j][0] == b
                    for b, s in out_shapes.items())
                for j in range(n_out)]
        self._warm_variants = self._pred.num_compiled_variants()
        return self._warm_variants

    # -- zero-downtime weight hot swap -------------------------------------
    def prewarm_predictor(self, pred,
                          rest_shapes: Optional[Sequence[Sequence[int]]]
                          = None) -> int:
        """Warm a *replacement* predictor on every bucket WITHOUT
        touching the serving one — runs entirely off the dispatch path
        (no engine lock: ``pred`` has no other caller yet), so a hot
        swap commits an already-warm predictor.  Returns its variant
        count.

        Raises if the replacement disagrees with this engine's input
        signature (names / per-row shapes / dtypes) — the pre-commit
        rejection path for a mismatched artifact."""
        names = list(pred.get_input_names())
        if names != self._input_names:
            raise ValueError(
                f"replacement artifact has inputs {names}, engine serves "
                f"{self._input_names}")
        for b, feeds in self._bucket_feeds(rest_shapes):
            pred.run(feeds)
        return pred.num_compiled_variants()

    def swap_predictor(self, pred, version: int):
        """Commit a prepared (loaded + digest-verified + prewarmed)
        predictor as the serving weights.  The commit is one pointer
        write under the engine's predictor lock — the batch boundary:
        an in-flight batch finishes on the old weights, the next batch
        runs on the new ones, nothing drains and no variant is added
        (``prewarm_predictor`` already ran every bucket).

        Returns the replaced predictor — the caller's rollback handle
        (swap it back if a later stage of a multi-engine swap fails).
        """
        with self._cv:
            if self._closing or self._closed:
                raise EngineClosed("engine is draining or closed")
        with self._pred_mu:
            old = self._pred
            self._pred = pred
            # the new predictor's variants are the new warm baseline —
            # recompiles_after_warmup stays 0 across a clean swap
            self._warm_variants = pred.num_compiled_variants()
            self._weights_version = int(version)
        with self._cv:
            self._c["weight_swaps"] += 1
        self._madd("weight_swaps")
        trc = obs_hook._tracer
        if trc is not None:
            trc.emit("serving", "weights_swap",
                     args=self._ev(version=int(version)))
        return old

    @property
    def weights_version(self) -> int:
        return self._weights_version

    def pause(self) -> None:
        """Testing hook: hold the dispatcher (no new batch starts)."""
        with self._cv:
            self._paused = True
            self._cv.notify_all()

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admission, finish everything queued and in flight.
        Returns True when fully drained within ``timeout``."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cv:
            self._draining = True
            self._paused = False    # a paused engine could never empty
            self._cv.notify_all()
            while self._queue or self._inflight:
                wait = 0.05
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return False
                self._cv.wait(wait)
        return True

    def close(self, timeout: float = 10.0) -> None:
        """Graceful shutdown: drain, stop the dispatcher, and fail any
        request that could not be served — no future is ever stranded.

        ``timeout`` is a hard deadline on the whole method, measured
        from entry: time spent contending for the engine lock counts
        against the dispatcher join, so a dispatcher wedged in a
        faulted dispatch (e.g. the ``serving.dispatch`` fault point
        with ``action=sleep``) can never hold ``close`` past its
        budget — the wedged batch's futures are failed and the thread
        is abandoned (it is a daemon and exits on its next state
        check)."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._cv:
            if self._closed:
                return
            self._draining = True
            self._closing = True
            self._paused = False        # a paused engine must still close
            self._cv.notify_all()
        self._thread.join(max(0.0, deadline - time.monotonic()))
        with self._cv:
            self._closed = True
            # only on join timeout / wedged dispatcher: fail everything
            # still queued AND the popped in-flight batch — a future must
            # never be stranded, even when the predictor hangs
            stranded = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            self._queued_deadlines = 0
            if self._thread.is_alive():
                stranded += [r for r in self._inflight_reqs
                             if not r.future.done()]
            for r in stranded:
                _safe_set_exception(r.future, EngineClosed(
                    "engine closed before the request was served"))
            if stranded:
                self._c["closed_stranded"] += len(stranded)
            self._cv.notify_all()
        if stranded:
            self._madd("closed_stranded", len(stranded))

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False

    # -- observability -----------------------------------------------------
    @property
    def buckets(self) -> List[int]:
        return list(self._buckets)

    def stats(self) -> Dict[str, object]:
        """Engine state + counters + latency percentiles (the payload
        behind the HTTP ``/metrics`` endpoint)."""
        with self._cv:
            state = ("closed" if self._closed else
                     "draining" if self._draining else
                     "paused" if self._paused else "running")
            c = dict(self._c)
            queue_depth = len(self._queue)
            queued_rows = self._queued_rows
            inflight = self._inflight
            occ_sum = self._occ_sum
        batches = c.get("batches", 0)
        rows = c.get("rows", 0)
        padded = c.get("padded_rows", 0)
        variants = self._pred.num_compiled_variants()
        return {
            "state": state,
            "engine": self.name,
            "queue_depth": queue_depth,
            "queued_rows": queued_rows,
            "inflight": inflight,
            "max_batch_size": self._max_batch,
            "max_queue": self._max_queue,
            "batch_timeout_ms": self._batch_timeout * 1000.0,
            "buckets": list(self._buckets),
            "counters": {k: c.get(k, 0) for k in (
                "requests", "responses", "batches", "rows", "padded_rows",
                "shed", "deadline_expired", "failed", "dispatch_errors",
                "dispatch_retries", "weight_swaps", "closed_stranded")},
            "weights_version": self._weights_version,
            "mean_batch_occupancy": (occ_sum / batches) if batches else 0.0,
            "padding_waste": (padded / (rows + padded))
            if (rows + padded) else 0.0,
            "requests_per_batch": (c.get("responses", 0) / batches)
            if batches else 0.0,
            "latency_ms": self._reg.histogram_summary("latency_ms"),
            "compiled_variants": variants,
            "warm_variants": self._warm_variants,
            "recompiles_after_warmup": (
                variants - self._warm_variants
                if self._warm_variants is not None else None),
        }
