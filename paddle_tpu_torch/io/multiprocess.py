"""DataLoader worker processes with shared-memory batch transport (the
counterpart of ``paddle_tpu/io/multiprocess.py``).

Workers are started by ``forkserver`` (``PADDLE_TPU_MP_START`` picks
another method): they fork from a clean server interpreter, never from
the training process, whose CUDA context a forked child could not use.
So the dataset and ``collate_fn`` must be picklable (module-level
classes).  A worker stays on the host: it sets the port's default
device to the CPU (a paddle Tensor it makes lands there), runs one torch
thread, and ships numpy arrays only.  Each batch crosses in one
``multiprocessing.shared_memory`` block; the parent copies every leaf
out of the block before it unlinks it, then copies it to the device
(one synchronous copy a leaf, on the step's stream).

Workers are persistent: the pool made at the first epoch serves every
later one (they see the dataset as pickled then).  A dead worker is
respawned in place and the batches it owed are dealt again (at most
``FLAGS_dataloader_batch_retries`` times a batch); deaths clustering
inside ``FLAGS_dataloader_crashloop_window_s`` respawn with exponential
backoff, and past ``FLAGS_dataloader_crashloop_budget`` the loader
raises :class:`WorkerCrashLoop` with the exit ledger.  Restarts show in
the ``monitor`` stats ``dataloader.worker_restarts`` and
``dataloader.batch_retries``.  The stall timeout is
``DataLoader(timeout=...)``, else ``FLAGS_dataloader_timeout``.  Each
worker owns private index and result SimpleQueues, so a hard-killed
worker can wedge only its own pipes, and at most ``prefetch_factor``
batches a worker are in flight."""
from __future__ import annotations

import atexit
import multiprocessing as mp
import os
import time
from multiprocessing import shared_memory
from typing import List

import numpy as np

from ..core import flags as _flags
from ..testing import fault
from ..utils import monitor

_live_shm: set = set()


class WorkerCrashLoop(RuntimeError):
    """DataLoader workers are dying faster than respawning can help
    (``FLAGS_dataloader_crashloop_budget`` deaths inside
    ``FLAGS_dataloader_crashloop_window_s``).  Carries ``exit_history``
    — the (worker_id, exit_code) ledger — so the operator sees what
    kept dying (OOM kills show -9, native crashes show the signal)."""

    def __init__(self, msg: str, exit_history):
        super().__init__(msg)
        self.exit_history = list(exit_history)


def _cleanup_shm():
    for name in list(_live_shm):
        try:
            s = shared_memory.SharedMemory(name=name)
            s.close()
            s.unlink()
        except Exception:
            pass


atexit.register(_cleanup_shm)


def _free_shm(name):
    if not name:
        return
    try:
        s = shared_memory.SharedMemory(name=name)
        s.close()
        s.unlink()
    except Exception:
        pass


def _flatten(tree, out):
    if isinstance(tree, np.ndarray):
        out.append(tree)
        return "*"
    if isinstance(tree, tuple):
        return tuple(_flatten(t, out) for t in tree)
    if isinstance(tree, list):
        return [_flatten(t, out) for t in tree]
    if isinstance(tree, dict):
        return {k: _flatten(v, out) for k, v in tree.items()}
    raise TypeError(f"cannot ship type {type(tree)} over shared memory")


def _unflatten(spec, leaves, it=None):
    if it is None:
        it = iter(leaves)
        return _unflatten(spec, leaves, it)
    if spec == "*":
        return next(it)
    if isinstance(spec, tuple):
        return tuple(_unflatten(s, leaves, it) for s in spec)
    if isinstance(spec, list):
        return [_unflatten(s, leaves, it) for s in spec]
    if isinstance(spec, dict):
        return {k: _unflatten(v, leaves, it) for k, v in spec.items()}
    raise TypeError(spec)


def _worker_loop(dataset, collate_fn, idx_q, result_q, worker_id,
                 worker_init_fn, seed, fault_spec=None):
    """Consume (tag, i, idxs) from this worker's PRIVATE idx_q, publish
    (tag, i, shm_name, spec, metas, err) on its PRIVATE result_q.

    The queues are SimpleQueues: ``put`` writes the pipe synchronously
    in this thread (no feeder), so once a result is put it SURVIVES any
    subsequent death of this process — and since no other worker shares
    these queues, dying mid-operation can wedge at most this worker's
    own pipes, which the parent replaces on respawn."""
    import torch

    from . import _np_collate, _to_numpy
    from ..core import placement
    torch.set_num_threads(1)
    placement.set_default(torch.device("cpu"))
    np.random.seed((seed + worker_id) % (2 ** 31))
    if fault_spec is not None:
        fault.arm(fault_spec[0], seed=fault_spec[1])
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = idx_q.get()
        if item is None:
            return
        tag, i, idxs = item
        # chaos hook: a rule like 'mp.worker_batch:count=1,action=exit,
        # match=batch=1' hard-kills one worker mid-epoch (the reference
        # SIGCHLD scenario)
        fault.point("mp.worker_batch", f"worker={worker_id}",
                    f"batch={i}")
        try:
            samples = [dataset[j] for j in idxs]
            batch = (_to_numpy(collate_fn(samples)) if collate_fn
                     else _np_collate([_to_numpy(s) for s in samples]))
            leaves: List[np.ndarray] = []
            spec = _flatten(batch, leaves)
            total = sum(a.nbytes for a in leaves)
            shm = shared_memory.SharedMemory(create=True,
                                             size=max(total, 1))
            # ownership passes to the parent (which unlinks after
            # tensorizing) — detach from this process's resource_tracker
            # so it doesn't warn about 'leaked' blocks at worker exit
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:
                pass
            metas, off = [], 0
            for a in leaves:
                shp = a.shape            # ascontiguousarray promotes 0-d
                a = np.ascontiguousarray(a)
                view = np.ndarray(a.shape, a.dtype, buffer=shm.buf,
                                  offset=off)
                view[...] = a
                metas.append((shp, a.dtype.str, off))
                off += a.nbytes
            shm.close()
            result_q.put((tag, i, shm.name, spec, metas, None))
        except Exception as e:  # surface the worker traceback in the parent
            import traceback
            result_q.put((tag, i, None, None, None,
                          f"{type(e).__name__}: {e}\n"
                          f"{traceback.format_exc()}"))


class _WorkerPool:
    """Persistent worker pool shared by successive epoch iterators.

    Dead workers are respawned in place (``restart_worker``) — the
    reference tears the whole reader down from its SIGCHLD handler; a
    preemptible pod can't afford that, so the pool self-heals and keeps
    a ledger of restarts + exit codes for the diagnostics.

    Each worker owns PRIVATE index/result SimpleQueues (torch's
    _index_queues layout).  This is the crash-safety load-bearing wall:
    a shared queue's cross-process locks die with whoever holds them
    (a worker killed mid-``put`` on a shared result queue wedges every
    other worker forever), while a private queue can only wedge its
    owner — and ``restart_worker`` replaces the queues along with the
    process."""

    def __init__(self, loader):
        method = os.environ.get("PADDLE_TPU_MP_START", "forkserver")
        if method not in mp.get_all_start_methods():
            method = "spawn"
        self._ctx = mp.get_context(method)
        if method == "forkserver":
            # workers fork from a server that has imported the main
            # module and the port once (it takes effect when the server
            # starts)
            self._ctx.set_forkserver_preload(["__main__", __name__])
        self._method = method
        self._loader = loader
        self._seed = int.from_bytes(os.urandom(4), "little")
        self.idx_qs: List = []
        self.res_qs: List = []
        self.workers: List = []
        self.epoch = 0
        self.restarts = 0
        self.exit_history: List[tuple] = []   # (worker_id, exit_code)
        self._death_times: List[float] = []   # crash-loop window ledger
        for w in range(loader.num_workers):
            try:
                self._spawn(w, respawn=False, replace=False)
            except Exception as e:
                self.close()
                raise RuntimeError(
                    f"DataLoader could not start a '{method}' worker "
                    f"({type(e).__name__}: {e}); a non-picklable dataset/"
                    f"collate_fn needs PADDLE_TPU_MP_START=fork or "
                    f"use_shared_memory=False") from e

    def _spawn(self, w, respawn, replace):
        loader = self._loader
        idx_q = self._ctx.SimpleQueue()
        res_q = self._ctx.SimpleQueue()
        p = self._ctx.Process(
            target=_worker_loop,
            args=(loader.dataset, loader.collate_fn, idx_q, res_q, w,
                  getattr(loader, "worker_init_fn", None), self._seed,
                  fault.spec_for_children(respawn=respawn)),
            daemon=True)
        p.start()
        # drop the parent's (unused) write end of the result pipe: once
        # the worker dies, reads hit EOF instead of blocking forever —
        # without this, a worker SIGKILLed mid-write of a result larger
        # than the pipe's atomic size would wedge drain_worker/close
        try:
            res_q._writer.close()
        except (OSError, AttributeError):
            pass
        if replace:
            self.idx_qs[w] = idx_q
            self.res_qs[w] = res_q
            self.workers[w] = p
        else:
            self.idx_qs.append(idx_q)
            self.res_qs.append(res_q)
            self.workers.append(p)

    def restart_worker(self, w) -> int:
        """Replace a dead worker — process AND queues (its pipes/locks
        may be wedged mid-operation); returns its exit code.

        Respawning is NOT free-running: deaths clustering inside
        ``FLAGS_dataloader_crashloop_window_s`` back off exponentially
        (first death respawns immediately — the common single-OOM case
        stays fast), and one death past
        ``FLAGS_dataloader_crashloop_budget`` raises
        :class:`WorkerCrashLoop` with the full exit ledger instead of
        burning ``FLAGS_dataloader_batch_retries`` in a tight loop."""
        dead = self.workers[w]
        dead.join(timeout=5)
        code = dead.exitcode
        self.exit_history.append((w, code))
        now = time.monotonic()
        window = float(_flags.get_flag("dataloader_crashloop_window_s"))
        self._death_times = [t for t in self._death_times
                             if now - t <= window] + [now]
        recent = len(self._death_times)
        budget = int(_flags.get_flag("dataloader_crashloop_budget"))
        if recent > budget:
            raise WorkerCrashLoop(
                f"DataLoader workers crash-looping: {recent} deaths "
                f"inside {window:.0f}s (budget {budget}).  Exit history "
                f"(worker, code): {self.exit_history} — repeated fast "
                f"deaths point at the dataset/collate_fn or a dying "
                f"node, not a transient fault; respawning harder "
                f"cannot fix it.", self.exit_history)
        if recent > 1:
            base = float(_flags.get_flag("dataloader_respawn_backoff_s"))
            cap = float(_flags.get_flag(
                "dataloader_respawn_backoff_max_s"))
            delay = min(base * (2 ** (recent - 2)), cap)
            monitor.stat_add("dataloader.respawn_backoff_s", delay)
            time.sleep(delay)
        self._spawn(w, respawn=True, replace=True)
        self.restarts += 1
        monitor.stat_add("dataloader.worker_restarts")
        from ..core import obs_hook
        trc = obs_hook._tracer
        if trc is not None:
            trc.emit("worker_restart", "dataloader.worker",
                     args={"worker": w, "exitcode": code,
                           "recent_deaths": recent})
        return code

    def drain_worker(self, w, handler):
        """Feed every already-readable result of worker ``w`` (the pipe
        contents survive the worker's death) to ``handler``; returns
        the number of messages handled (0 at EOF — dead worker)."""
        q = self.res_qs[w]
        n = 0
        while True:
            try:
                if not q._reader.poll():
                    return n
                msg = q.get()
            except (OSError, ValueError, EOFError):
                return n
            handler(w, msg)
            n += 1

    def close(self):
        for w, p in enumerate(self.workers):
            if p.is_alive():
                p.terminate()
        for p in self.workers:
            p.join(timeout=5)
        for q in self.res_qs:      # free shm of undelivered results
            while True:
                try:
                    if not q._reader.poll():
                        break
                    item = q.get()
                except (OSError, ValueError, EOFError):
                    break
                name = item[2] if len(item) >= 3 else None
                if isinstance(name, str):
                    _free_shm(name)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def get_pool(loader) -> _WorkerPool:
    pool = getattr(loader, "_mp_pool", None)
    if pool is None or not all(p.is_alive() for p in pool.workers):
        if pool is not None:
            pool.close()
        pool = _WorkerPool(loader)
        loader._mp_pool = pool
    return pool


class MultiprocessIterator:
    """Ordered batch producer over the loader's persistent pool.

    The parent is the scheduler: it deals batches to each worker's
    private index queue (at most ``prefetch_factor`` in flight per
    worker) and tracks exactly what it dealt.  Worker results are
    synchronous pipe writes, so on a worker death the undelivered
    remainder of its deal — no more, no less — is re-dealt, and the
    retry budget is charged only to the batch the worker was actually
    chewing (the oldest undelivered one: workers run their queue in
    order)."""

    def __init__(self, loader, sampler_iter):
        from collections import deque
        self.loader = loader
        self.pool = get_pool(loader)
        self.pool.epoch += 1
        self.tag = self.pool.epoch
        self.batches = list(sampler_iter)
        self.total = len(self.batches)
        self.pending = {}
        self.next_emit = 0
        self.timeout = (getattr(loader, "timeout", 0)
                        or _flags.get_flag("dataloader_timeout"))
        self.retry_budget = int(
            _flags.get_flag("dataloader_batch_retries"))
        self.retries: dict = {}               # batch index -> re-deals
        # backpressure: at most prefetch_factor batches in flight per
        # worker, so /dev/shm holds a bounded window, not the whole epoch
        self._per_worker = max(
            int(getattr(loader, "prefetch_factor", 2)), 1)
        self.todo = deque(range(self.total))
        self.inflight = {w: deque()
                         for w in range(len(self.pool.workers))}
        self._fill()

    def _fill(self):
        """Deal todo batches to workers with free credit."""
        progress = True
        while self.todo and progress:
            progress = False
            for w, fl in self.inflight.items():
                if not self.todo:
                    break
                if len(fl) < self._per_worker:
                    i = self.todo.popleft()
                    self.pool.idx_qs[w].put(
                        (self.tag, i, list(self.batches[i])))
                    fl.append(i)
                    progress = True

    def _worker_status(self):
        return ", ".join(
            f"w{w}:{'alive' if p.is_alive() else p.exitcode}"
            for w, p in enumerate(self.pool.workers))

    def _ingest(self, w, msg):
        """Fold one result message from worker ``w`` into pending."""
        tag, i, name, spec, metas, err = msg
        if tag != self.tag:
            # stale result from an abandoned earlier epoch: free it
            _free_shm(name)
            return
        try:
            self.inflight[w].remove(i)
        except ValueError:
            pass
        if i < self.next_emit or i in self.pending:
            # duplicate of a re-dealt batch that survived after all:
            # every batch is emitted exactly once — drop it (even a
            # failed re-execution of an already-delivered batch)
            _free_shm(name)
            return
        if err is not None:
            self.pool.close()
            self.loader._mp_pool = None
            raise RuntimeError(f"DataLoader worker failed:\n{err}")
        self.pending[i] = (name, spec, metas)

    def _heal(self, dead):
        """Respawn dead workers (fresh queues) and re-deal exactly the
        batches they still owed.  Raises when a batch burns through its
        retry budget — a batch that kills every worker that touches it
        is a dataset bug, not a flaky node."""
        for w in dead:
            # the pipe outlives the process: collect results it
            # delivered before dying, so they aren't re-dealt
            self.pool.drain_worker(w, self._ingest)
            lost = list(self.inflight[w])
            self.inflight[w].clear()
            try:
                self.pool.restart_worker(w)
            except WorkerCrashLoop:
                # fast-fail: tear the pool down before surfacing, so
                # the crash loop doesn't leave zombie workers behind
                self.pool.close()
                self.loader._mp_pool = None
                raise
            if not lost:
                continue
            # workers run FIFO, so the oldest undelivered batch is the
            # one that was being processed at death: it takes the blame
            killer = lost[0]
            self.retries[killer] = self.retries.get(killer, 0) + 1
            if self.retries[killer] > self.retry_budget:
                self.pool.close()
                self.loader._mp_pool = None
                raise RuntimeError(
                    f"DataLoader batch(es) [{killer}] still failing "
                    f"after {self.retry_budget} worker-death retries "
                    f"(exit codes: {self.pool.exit_history}) — giving "
                    f"up.  A batch that repeatedly kills its worker "
                    f"points at the dataset/collate_fn (OOM, native "
                    f"crash), not a transient fault.")
            self.todo.extendleft(reversed(lost))
            monitor.stat_add("dataloader.batch_retries", len(lost))
        self._fill()

    def __iter__(self):
        return self

    def _tensorize(self, shm_name, spec, metas):
        from . import _device_tensor
        shm = shared_memory.SharedMemory(name=shm_name)
        _live_shm.add(shm_name)
        leaves = []
        for shape, dtype, off in metas:
            view = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf,
                              offset=off)
            # copied out of the block before it is unlinked below
            leaves.append(_device_tensor(view.copy()))
        shm.close()
        try:
            shm2 = shared_memory.SharedMemory(name=shm_name)
            shm2.close()
            shm2.unlink()
        except FileNotFoundError:
            pass
        _live_shm.discard(shm_name)
        return _unflatten(spec, leaves)

    def __next__(self):
        from multiprocessing import connection as mp_conn
        if self.next_emit >= self.total:
            raise StopIteration
        poll = min(self.timeout, 2.0)
        waited = 0.0
        while self.next_emit not in self.pending:
            readers = {q._reader: w
                       for w, q in enumerate(self.pool.res_qs)}
            try:
                ready = mp_conn.wait(list(readers), timeout=poll)
            except OSError:
                ready = []
            handled = 0
            for r in ready:
                handled += self.pool.drain_worker(readers[r],
                                                  self._ingest)
            if handled:
                self._fill()
                waited = 0.0
                continue
            # nothing arrived: timed out, or a ready reader was a dead
            # worker's EOF'd pipe — check for deaths before looping so
            # an EOF'd pipe can't spin us without ever healing
            dead = [w for w, p in enumerate(self.pool.workers)
                    if not p.is_alive()]
            if dead:
                # self-heal: respawn + re-deal, then keep waiting
                self._heal(dead)
                waited = 0.0
                continue
            if ready:
                # momentary race (EOF visible, is_alive not yet False):
                # yield briefly; the next pass will see the death
                time.sleep(0.05)
                continue
            waited += poll
            if waited < self.timeout:
                continue              # alive but slow (loaded machine)
            self.pool.close()
            self.loader._mp_pool = None
            raise RuntimeError(
                f"DataLoader stalled: no batch for {self.timeout}s "
                f"with all workers alive ({self._worker_status()}; "
                f"restarts so far: {self.pool.exit_history or 'none'})"
                f" — raise DataLoader(timeout=...) or "
                f"FLAGS_dataloader_timeout for slow datasets.  If "
                f"the dataset/collate is defined in a script's "
                f"__main__, forkserver workers re-import the script "
                f"(python spawn semantics): guard it with `if "
                f"__name__ == '__main__'`, move the dataset to a "
                f"module, or set PADDLE_TPU_MP_START=fork.")
        name, spec, metas = self.pending.pop(self.next_emit)
        self.next_emit += 1
        self._fill()
        from . import _emit_batch
        return _emit_batch(self._tensorize(name, spec, metas),
                           self.next_emit - 1)
