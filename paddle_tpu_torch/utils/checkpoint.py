"""Versioned, digest-verified snapshot directories (the counterpart of
``paddle_tpu/utils/checkpoint.py``'s :class:`SnapshotStore`).

A snapshot is one ``<name>.pdparams`` file per registered object (the
object's ``state_dict()`` in the port's :func:`~..framework_io.dumps`
wire format, which paddle_tpu reads too), written under
``<dir>/epoch_<n>/`` or ``<dir>/step_<s>/`` and published atomically
through ``<dir>/range_meta.json``, whose ``snapshots`` list carries each
file's sha256.  Every write goes to a temporary file that is renamed,
so a crash mid-save never leaves a truncated file or meta; restore
re-verifies the digests and never part-loads: a corrupt or missing file
falls back to the previous intact snapshot (the meta keeps the last
``keep_max``) or raises :class:`CheckpointError`.

:meth:`SnapshotStore.save_async` captures the state on the caller's
thread and publishes (digests, writes, meta) on one background thread,
so publish order is the enqueue order; :meth:`SnapshotStore.flush`
waits for it.  :meth:`SnapshotStore.latest_snapshot` and
:meth:`SnapshotStore.load_payloads` are the serving side's poll and
verified read (``serving.hotswap``).

An object with ``shard_state`` (``distributed.sharding.ShardedState``,
e.g. ``Executor.sharded_state``) is saved by the sharded protocol: a
``<name>.manifest.json`` and one ``<name>.<file>`` payload per unique
block, each with its own digest, so a corrupt block is caught alone;
restore hands the manifest and the decoded blocks to its
``load_shard_state``, which reshards onto the live mesh.  In a job of
several ranks every rank calls ``save``/``restore`` together (the
blocks are gathered); world rank 0 writes and the ranks meet at a
barrier after a synchronous save.

The fault points are paddle_tpu's: ``ckpt.publish``, ``ckpt.save``,
``ckpt.restore`` and the file operations' ``fs.open_read``,
``fs.open_write``, ``fs.mkdir``, ``fs.remove``, ``fs.list`` and
``fs.mv``.  Paths are local: a ``scheme://`` path raises
``NotImplementedError`` (paddle_tpu's ``utils/fs``, ROADMAP A6, is not
ported).  ``TrainEpochRange``, ``train_epoch_range`` and the preemption
handler stay with A6 too.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import warnings
from typing import Dict, List, Optional, Sequence

from . import monitor
from ..core import flags as _flags
from ..core import obs_hook as _obs_hook
from ..framework_io import dumps as _dumps
from ..framework_io import loads as _loads
from ..testing import fault

__all__ = ["CheckpointError", "SnapshotStore", "write_atomic"]


class CheckpointError(RuntimeError):
    """No intact snapshot could be restored (corrupt/missing state)."""


def _local(path: str) -> str:
    if "://" in str(path):
        raise NotImplementedError(
            f"{path!r}: filesystem schemes (paddle_tpu's utils/fs, ROADMAP "
            f"A6) are not ported yet; pass a local path")
    return os.fspath(path)


# the file operations, with paddle_tpu's ``fs.*`` fault points
def _open_read(path):
    fault.point("fs.open_read", path)
    return open(path, "rb")


def _open_write(path):
    fault.point("fs.open_write", path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return open(path, "wb")


def _mkdir(path):
    fault.point("fs.mkdir", path)
    os.makedirs(path, exist_ok=True)


def _remove(path):
    fault.point("fs.remove", path)
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def _list(path):
    fault.point("fs.list", path)
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def _mv(src, dst):
    fault.point("fs.mv", src, dst)
    os.replace(src, dst)


def write_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through a temporary file and a rename,
    so a crash mid-write never leaves a truncated file."""
    path = _local(path)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with _open_write(tmp) as f:
        f.write(data)
    try:
        _mv(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


class SnapshotStore:
    """Versioned, digest-verified snapshot directory.

    Layout: ``<dir>/epoch_<n>/<name>.pdparams`` per registered object,
    published atomically through ``<dir>/range_meta.json`` whose
    ``snapshots`` list carries per-file sha256 digests.  Keeps the last
    ``keep_max`` snapshots (default ``FLAGS_checkpoint_keep_max``) so a
    corrupt latest can fall back.  Restored and loaded tensors land on
    ``set_device``'s choice, else the current CUDA device; numpy arrays
    stay numpy."""

    META = "range_meta.json"

    def __init__(self, directory: str, keep_max: Optional[int] = None,
                 verify: bool = True):
        self.dir = _local(directory)
        self.keep_max = max(1, int(
            keep_max if keep_max is not None
            else _flags.get_flag("checkpoint_keep_max")))
        self.verify = verify
        _mkdir(self.dir)
        # the snapshot applied by the last restore() (its meta entry)
        self.last_restored: Optional[dict] = None
        # background publisher (save_async): one thread does digests,
        # writes and the meta publish, in enqueue order
        self._pub_cv = threading.Condition()
        self._pub_queue: Optional[queue.SimpleQueue] = None
        self._pub_thread: Optional[threading.Thread] = None
        self._pub_pending = 0
        self._pub_error: Optional[BaseException] = None

    def _join(self, *parts) -> str:
        return "/".join([self.dir.rstrip("/")] + list(parts))

    def _meta_path(self) -> str:
        return self._join(self.META)

    def load_meta(self) -> Optional[dict]:
        try:
            with _open_read(self._meta_path()) as f:
                meta = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError, RuntimeError):
            return None
        # v1 metas (before digests) carried only the latest snapshot
        if "snapshots" not in meta:
            meta["snapshots"] = [{"epoch": int(meta.get(
                "finished_epoch", -1)), "dir": meta.get("snapshot", ""),
                "digests": None}]
        return meta

    # -- save --------------------------------------------------------------
    @staticmethod
    def _encode(objects: Dict[str, object]) -> Dict[str, bytes]:
        """Every object's state as bytes, on the caller's thread (the
        consistency half of a save; the publish may be deferred).  A
        sharded object gives a manifest and one payload per block."""
        files: Dict[str, bytes] = {}
        for name, obj in objects.items():
            if hasattr(obj, "shard_state"):
                manifest, payloads = obj.shard_state()
                files[f"{name}.manifest.json"] = json.dumps(
                    manifest).encode("utf-8")
                for fname, data in payloads.items():
                    files[f"{name}.{fname}"] = data
                continue
            files[f"{name}.pdparams"] = _dumps(obj.state_dict())
        return files

    @staticmethod
    def _job():
        """(this process writes, the job's world size): in a job of
        several ranks only world rank 0 writes."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0, dist.get_world_size()
        return True, 1

    def _publish(self, epoch: int, files: Dict[str, bytes],
                 object_names: List[str], step: Optional[int] = None,
                 kind: str = "epoch") -> None:
        """Write payloads and digests, then atomically publish the meta
        (the durability half of a save)."""
        snap = f"step_{step}" if kind == "step" else f"epoch_{epoch}"
        sdir = self._join(snap)
        _mkdir(sdir)
        digests = {}
        for fname, data in files.items():
            digests[fname] = hashlib.sha256(data).hexdigest()
            write_atomic(f"{sdir}/{fname}", data)
        meta = self.load_meta() or {"snapshots": []}
        snaps = [s for s in meta["snapshots"] if s.get("dir") != snap]
        entry = {"epoch": int(epoch), "dir": snap, "digests": digests,
                 "kind": kind}
        if step is not None:
            entry["step"] = int(step)
        snaps.append(entry)
        snaps = snaps[-self.keep_max:]
        # a step snapshot mid-epoch E means E is NOT finished
        finished = int(epoch) if kind == "epoch" else int(epoch) - 1
        meta = {"finished_epoch": finished, "snapshot": snap,
                "objects": sorted(object_names), "snapshots": snaps}
        fault.point("ckpt.publish", self.dir, epoch)
        write_atomic(self._meta_path(), json.dumps(meta).encode("utf-8"))
        monitor.stat_add("checkpoint.saves")
        trc = _obs_hook._tracer
        if trc is not None:
            trc.emit("checkpoint", "save",
                     args={"epoch": int(epoch), "step": step,
                           "kind": kind, "dir": self.dir})
        keep = {s["dir"] for s in snaps}
        for d in _list(self.dir):
            if (d.startswith("epoch_") or d.startswith("step_")) \
                    and d not in keep:
                try:
                    _remove(self._join(d))
                except (RuntimeError, OSError):
                    pass    # pruning is best-effort (shared dirs, perms)

    def save(self, epoch: int, objects: Dict[str, object],
             step: Optional[int] = None, kind: str = "epoch") -> None:
        """Synchronous save: capture and publish on this thread, after
        any queued background publishes (the meta never moves back past
        a snapshot already captured)."""
        fault.point("ckpt.save", self.dir, epoch)
        self.flush()
        files = self._encode(objects)
        writer, world = self._job()
        if writer:
            self._publish(epoch, files, sorted(objects), step=step,
                          kind=kind)
        if world > 1:
            import torch.distributed as dist
            dist.barrier()

    # -- background publish ------------------------------------------------
    def save_async(self, epoch: int, objects: Dict[str, object],
                   step: Optional[int] = None,
                   kind: str = "step") -> None:
        """Capture now (caller's thread), publish on the store's
        background thread.  A failed publish is warned and counted
        (``checkpoint.async_errors``), not raised into the caller;
        :meth:`flush` waits for durability."""
        fault.point("ckpt.save", self.dir, epoch)
        job = {"epoch": int(epoch), "files": self._encode(objects),
               "object_names": sorted(objects), "step": step,
               "kind": kind}
        if not self._job()[0]:
            return
        with self._pub_cv:
            if self._pub_thread is None or not self._pub_thread.is_alive():
                self._pub_queue = queue.SimpleQueue()
                self._pub_thread = threading.Thread(
                    target=self._publish_loop, name="snapshot-publisher",
                    daemon=True)
                self._pub_thread.start()
            self._pub_pending += 1
        self._pub_queue.put(job)
        monitor.stat_add("checkpoint.async_saves")

    def _publish_loop(self) -> None:
        while True:
            job = self._pub_queue.get()
            if job is None:
                return
            try:
                self._publish(**job)
            except BaseException as e:  # noqa: BLE001 - kept, not raised
                with self._pub_cv:
                    self._pub_error = e
                monitor.stat_add("checkpoint.async_errors")
                warnings.warn(
                    f"checkpoint: background publish of "
                    f"{job.get('kind')} snapshot (epoch {job.get('epoch')}"
                    f", step {job.get('step')}) failed: {e}")
            finally:
                with self._pub_cv:
                    self._pub_pending -= 1
                    self._pub_cv.notify_all()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until every queued background publish has landed.
        Returns False on timeout."""
        with self._pub_cv:
            return self._pub_cv.wait_for(
                lambda: self._pub_pending == 0, timeout)

    # -- restore -----------------------------------------------------------
    def _read_file_verified(self, snap: dict, fname: str,
                            digests: Optional[dict]) -> Optional[bytes]:
        path = self._join(snap["dir"], fname)
        try:
            with _open_read(path) as f:
                payload = f.read()
        except (OSError, RuntimeError) as e:
            warnings.warn(f"checkpoint {snap['dir']}: cannot read "
                          f"'{fname}': {e}")
            return None
        if self.verify and digests is not None:
            got = hashlib.sha256(payload).hexdigest()
            if got != digests[fname]:
                warnings.warn(
                    f"checkpoint {snap['dir']}: sha256 mismatch for "
                    f"'{fname}' (stored {digests[fname][:12]}…, "
                    f"recomputed {got[:12]}…)")
                return None
        return payload

    def _read_verified(self, snap: dict,
                       names: Sequence[str]) -> Optional[dict]:
        """All payloads of one snapshot, digest-checked, or None with a
        warning naming what failed (missing file, bad hash).  A sharded
        object comes back as ``("__sharded__", manifest, {file:
        bytes})``, every block verified against its own digest."""
        digests = snap.get("digests")
        payloads = {}
        for name in names:
            mf = f"{name}.manifest.json"
            if digests is not None and mf in digests:
                raw = self._read_file_verified(snap, mf, digests)
                if raw is None:
                    return None
                try:
                    manifest = json.loads(raw.decode("utf-8"))
                except ValueError as e:
                    warnings.warn(f"checkpoint {snap['dir']}: corrupt "
                                  f"manifest '{mf}': {e}")
                    return None
                blobs = {}
                for leaf in manifest.get("leaves", []):
                    for sh in leaf.get("shards", []):
                        full = f"{name}.{sh['file']}"
                        if full not in digests:
                            warnings.warn(
                                f"checkpoint {snap['dir']}: manifest "
                                f"names '{full}' but it carries no digest")
                            return None
                        data = self._read_file_verified(snap, full, digests)
                        if data is None:
                            return None
                        blobs[sh["file"]] = data
                payloads[name] = ("__sharded__", manifest, blobs)
                continue
            fname = f"{name}.pdparams"
            if digests is not None and fname not in digests:
                warnings.warn(
                    f"checkpoint {snap['dir']}: registered object "
                    f"'{name}' was never saved in this snapshot")
                return None
            payload = self._read_file_verified(snap, fname, digests)
            if payload is None:
                return None
            payloads[name] = payload
        return payloads

    def restore(self, objects: Dict[str, object]) -> int:
        """Load the newest intact snapshot into ``objects`` and return
        the next epoch to run (for a step snapshot: the epoch to
        re-enter; its ``step`` is on :attr:`last_restored`).  Falls
        back across the retained history; raises
        :class:`CheckpointError` when a meta exists but no snapshot
        verifies — never resumes half-initialized."""
        self.last_restored = None
        meta = self.load_meta()
        if meta is None:
            return 0
        attempts = []
        for snap in reversed(meta["snapshots"]):
            fault.point("ckpt.restore", self.dir, snap.get("dir"))
            payloads = self._read_verified(snap, list(objects))
            if payloads is None:
                attempts.append(str(snap.get("dir")))
                monitor.stat_add("checkpoint.fallbacks")
                trc = _obs_hook._tracer
                if trc is not None:
                    trc.emit("checkpoint", "fallback",
                             args={"snapshot": str(snap.get("dir")),
                                   "dir": self.dir})
                continue
            # decode everything BEFORE applying anything: a corrupt
            # payload that slipped past hashing still can't part-load
            states = {}
            for name, p in payloads.items():
                if isinstance(p, tuple) and p[0] == "__sharded__":
                    states[name] = ("__sharded__", p[1], {
                        f: _loads(b) for f, b in p[2].items()})
                else:
                    states[name] = _loads(p)
            for name, obj in objects.items():
                st = states[name]
                if isinstance(st, tuple) and st[0] == "__sharded__":
                    # reshard onto the mesh live now (gather-free when
                    # the saved layout is the live one)
                    obj.load_shard_state(st[1], st[2])
                else:
                    obj.set_state_dict(st)
            if attempts:
                warnings.warn(
                    f"checkpoint: snapshot(s) {attempts} failed "
                    f"verification; resumed from older intact "
                    f"'{snap['dir']}' (epoch {snap['epoch']})")
            monitor.stat_add("checkpoint.restores")
            trc = _obs_hook._tracer
            if trc is not None:
                trc.emit("checkpoint", "restore",
                         args={"epoch": int(snap["epoch"]),
                               "snapshot": str(snap["dir"]),
                               "step": snap.get("step"),
                               "fell_back_past": attempts})
            self.last_restored = dict(snap)
            if snap.get("kind") == "step":
                return int(snap["epoch"])       # re-enter mid-epoch
            return int(snap["epoch"]) + 1
        raise CheckpointError(
            f"checkpoint dir '{self.dir}' has a published meta but no "
            f"intact snapshot (tried {attempts}); refusing to resume "
            f"half-initialized — delete the dir to restart from scratch")

    # -- polling consumers (serving weight hot swap) -----------------------
    def latest_snapshot(self) -> Optional[dict]:
        """The newest published snapshot's meta entry (``dir``,
        ``epoch``, ``step``, ``digests``), or None: one meta read, no
        payload I/O — the serving side's poll."""
        meta = self.load_meta()
        if meta is None or not meta.get("snapshots"):
            return None
        return dict(meta["snapshots"][-1])

    def load_payloads(self, names: Sequence[str],
                      snap: Optional[dict] = None) -> Optional[dict]:
        """Read, sha256-verify and decode the named payloads of one
        snapshot (default: the newest) without applying them.

        Returns ``{name: decoded state dict}``, or None when the
        snapshot is missing, corrupt or partial (a warning names what
        failed): a rejection, not an exception, so a polling consumer
        keeps serving what it has."""
        if snap is None:
            snap = self.latest_snapshot()
            if snap is None:
                return None
        payloads = self._read_verified(snap, list(names))
        if payloads is None:
            return None
        out = {}
        for name, p in payloads.items():
            if isinstance(p, tuple) and p[0] == "__sharded__":
                warnings.warn(
                    f"checkpoint {snap.get('dir')}: payload '{name}' is "
                    f"sharded; load_payloads serves replicated weights "
                    f"only")
                return None
            try:
                out[name] = _loads(p)
            except Exception as e:      # decode failure == corruption
                warnings.warn(f"checkpoint {snap.get('dir')}: payload "
                              f"'{name}' failed to decode: {e}")
                return None
        return out
