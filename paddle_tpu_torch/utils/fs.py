"""Filesystems for checkpoints and models (the counterpart of
``paddle_tpu/utils/fs.py``).

One :class:`FileSystem` protocol, a scheme registry (:func:`register_fs`)
and dispatch by path prefix (:func:`get_fs`): ``paddle.save`` /
``paddle.load``, :class:`~.checkpoint.SnapshotStore` and
:class:`~.checkpoint.TrainEpochRange` route every byte through
:func:`open_read` / :func:`open_write`, so a checkpoint can live under
``hdfs://...`` (the ``hadoop fs`` CLI, :class:`ShellFS`) or any
registered store with no change to training code.

Errors are classified (:class:`TransientFSError` against
:class:`PermanentFSError`); transient ones are retried with exponential
backoff and jitter under ``FLAGS_fs_retry_times``,
``FLAGS_fs_retry_backoff_s`` and the ``FLAGS_fs_retry_deadline_s`` wall
clock, and a full disk, a read-only mount or a blown quota fail at once.
:class:`ShellFS` retries itself; a registered filesystem opts in with
``register_fs(scheme, fs, retry=True)``.  Retries show in the ``monitor``
stats ``fs.retries`` / ``fs.gave_up`` / ``fs.permanent``, and the fault
points ``fs.<op>`` and ``fs.shell_run`` sit inside the retry scope."""
from __future__ import annotations

import errno
import io
import os
import random
import shutil
import subprocess
import time
from typing import Dict, List

from ..testing import fault


class FSError(RuntimeError):
    """Base class for classified filesystem errors."""


class TransientFSError(FSError):
    """Error worth retrying: network blips, timeouts, busy services."""


class PermanentFSError(FSError):
    """Error retries cannot fix: missing paths, permissions, bad args."""


_TRANSIENT_ERRNOS = frozenset({
    errno.EAGAIN, errno.EINTR, errno.EBUSY, errno.ETIMEDOUT,
    errno.ECONNRESET, errno.ECONNREFUSED, errno.ECONNABORTED,
    errno.ENETUNREACH, errno.ENETRESET, errno.EHOSTUNREACH,
    errno.EPIPE, errno.EIO,
})

# Errnos no amount of backoff can fix: a full disk, a read-only mount,
# a blown quota.  These fail FAST as PermanentFSError — spending the
# whole FLAGS_fs_retry_deadline_s on them just delays the operator
# learning the volume is full.
_PERMANENT_ERRNOS = frozenset({
    errno.ENOSPC, errno.EROFS, errno.EDQUOT,
})

# Substrings of hadoop-CLI stderr that mark a retryable condition
# (connection issues, HDFS safe mode, throttling) vs a semantic failure.
_TRANSIENT_MARKERS = (
    "connection refused", "connection reset", "connection timed out",
    "timed out", "timeout", "temporarily unavailable", "try again",
    "safe mode", "safemode", "socketexception", "sockettimeout",
    "broken pipe", "service unavailable", "slow down",
    "too many requests", "network is unreachable", "lease recovery",
    "could not obtain block", "retriableexception",
)
_PERMANENT_MARKERS = (
    "no such file", "file exists", "permission denied", "access denied",
    "is a directory", "not a directory", "invalid argument",
    "unsupported", "illegalargument", "filenotfound",
    "no space left", "disk quota exceeded", "quota exceeded",
    "read-only file system", "read only file system",
)


def is_transient(exc: BaseException) -> bool:
    """Classify an exception as transient (retryable) or permanent."""
    if isinstance(exc, TransientFSError):
        return True
    if isinstance(exc, PermanentFSError):
        return False
    if isinstance(exc, (FileNotFoundError, PermissionError,
                        IsADirectoryError, NotADirectoryError,
                        FileExistsError)):
        return False
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return True
    if isinstance(exc, OSError):
        if exc.errno in _PERMANENT_ERRNOS:     # disk full / read-only
            return False
        return exc.errno in _TRANSIENT_ERRNOS
    return False


_retry_rng = random.Random()


def retry_call(op_name: str, fn, *args, **kwargs):
    """Run ``fn`` retrying transient failures: exponential backoff with
    jitter, bounded by ``FLAGS_fs_retry_times`` attempts and the
    ``FLAGS_fs_retry_deadline_s`` wall clock.  Non-transient errors and
    exhausted budgets re-raise the last (classified) error.  ``op_name``
    tags the per-op monitor stats (``fs.retries.<op>``) alongside the
    ``fs.retries``/``fs.gave_up`` aggregates."""
    from ..core import flags
    from . import monitor
    times = max(1, int(flags.get_flag("fs_retry_times")))
    base = float(flags.get_flag("fs_retry_backoff_s"))
    deadline = float(flags.get_flag("fs_retry_deadline_s"))
    start = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            attempt += 1
            if not is_transient(e):
                if isinstance(e, OSError) and not isinstance(e, FSError) \
                        and e.errno in _PERMANENT_ERRNOS:
                    # surface the classification: callers (and the
                    # monitor) see an explicit PermanentFSError, not a
                    # bare OSError they might be tempted to retry
                    monitor.stat_add("fs.permanent")
                    monitor.stat_add(f"fs.permanent.{op_name}")
                    raise PermanentFSError(
                        f"fs.{op_name}: unrecoverable "
                        f"({errno.errorcode.get(e.errno, e.errno)}): {e}"
                    ) from e
                raise
            elapsed = time.monotonic() - start
            if attempt >= times or elapsed >= deadline:
                monitor.stat_add("fs.gave_up")
                monitor.stat_add(f"fs.gave_up.{op_name}")
                raise
            monitor.stat_add("fs.retries")
            monitor.stat_add(f"fs.retries.{op_name}")
            from ..core import obs_hook
            trc = obs_hook._tracer
            if trc is not None:
                trc.counter(f"fs.retries.{op_name}", 1)
            delay = min(base * (2 ** (attempt - 1)), 10.0)
            delay *= 1.0 + 0.25 * _retry_rng.random()      # jitter
            delay = min(delay, max(0.0, deadline - elapsed))
            if delay > 0:
                time.sleep(delay)


def retrying(op_name: str):
    """Decorator form of :func:`retry_call` for filesystem methods."""
    def deco(fn):
        def wrapped(*args, **kwargs):
            return retry_call(op_name, fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", op_name)
        wrapped.__doc__ = fn.__doc__
        return wrapped
    return deco


class FileSystem:
    """Protocol: byte-level ops a checkpoint store needs (fs.h surface)."""

    def open_read(self, path: str) -> io.BufferedIOBase:
        raise NotImplementedError

    def open_write(self, path: str) -> io.BufferedIOBase:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def mkdir(self, path: str) -> None:
        raise NotImplementedError

    def remove(self, path: str) -> None:
        raise NotImplementedError

    def list(self, path: str) -> List[str]:
        raise NotImplementedError

    def mv(self, src: str, dst: str) -> None:
        raise NotImplementedError


class LocalFS(FileSystem):
    """fs.cc localfs_*: plain files + atomic-rename mv."""

    def open_read(self, path):
        fault.point("fs.open_read", path)
        return open(path, "rb")

    def open_write(self, path):
        fault.point("fs.open_write", path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        return open(path, "wb")

    def exists(self, path):
        fault.point("fs.exists", path)
        return os.path.exists(path)

    def mkdir(self, path):
        fault.point("fs.mkdir", path)
        os.makedirs(path, exist_ok=True)

    def remove(self, path):
        fault.point("fs.remove", path)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def list(self, path):
        fault.point("fs.list", path)
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    def mv(self, src, dst):
        fault.point("fs.mv", src, dst)
        os.replace(src, dst)


class RetryingFS(FileSystem):
    """Wrap any FileSystem with the transient-retry loop.  Registered
    schemes opt in via ``register_fs(scheme, fs, retry=True)``."""

    def __init__(self, inner: FileSystem):
        self.inner = inner

    def open_read(self, path):
        return retry_call("open_read", self.inner.open_read, path)

    def open_write(self, path):
        return retry_call("open_write", self.inner.open_write, path)

    def exists(self, path):
        return retry_call("exists", self.inner.exists, path)

    def mkdir(self, path):
        return retry_call("mkdir", self.inner.mkdir, path)

    def remove(self, path):
        return retry_call("remove", self.inner.remove, path)

    def list(self, path):
        return retry_call("list", self.inner.list, path)

    def mv(self, src, dst):
        return retry_call("mv", self.inner.mv, src, dst)


class PrefixStripFS(FileSystem):
    """Adapter mapping ``scheme://<path>`` onto an inner filesystem's
    plain paths — lets tests and chaos tools mount a LocalFS-backed dir
    under a registered scheme (e.g. ``flaky:///data/ckpt``)."""

    def __init__(self, inner: FileSystem, scheme: str):
        self.inner = inner
        self._prefix = scheme.rstrip(":/") + "://"

    def _p(self, path: str) -> str:
        if path.startswith(self._prefix):
            return path[len(self._prefix):]
        return path

    def open_read(self, path):
        return self.inner.open_read(self._p(path))

    def open_write(self, path):
        return self.inner.open_write(self._p(path))

    def exists(self, path):
        return self.inner.exists(self._p(path))

    def mkdir(self, path):
        return self.inner.mkdir(self._p(path))

    def remove(self, path):
        return self.inner.remove(self._p(path))

    def list(self, path):
        return self.inner.list(self._p(path))

    def mv(self, src, dst):
        return self.inner.mv(self._p(src), self._p(dst))


class ShellFS(FileSystem):
    """HDFS-style filesystem driven through a shell CLI (fs.cc hdfs_*:
    every op is ``{command} fs -<verb>``).  ``command`` defaults to the
    ``hadoop`` binary; AFS or other HDFS-compatible stores override it
    (the reference's HADOOP_HOME + ugi configs).

    Every op classifies CLI failures (transient net blips / safe mode /
    throttling vs semantic errors) and retries transient ones under the
    FLAGS_fs_retry_* budget — fs.cc's fs_retry_times analog.  A missing
    path is classified permanent, so :meth:`exists` answers False
    immediately instead of burning the retry budget."""

    def __init__(self, command: str = "hadoop"):
        self.command = command

    def _run_once(self, *args, input_bytes=None, capture=True):
        fault.point("fs.shell_run", self.command, *args)
        try:
            return subprocess.run(
                [self.command, "fs", *args], input=input_bytes,
                capture_output=capture, check=True)
        except FileNotFoundError as e:
            raise PermanentFSError(
                f"ShellFS: '{self.command}' CLI not found — install it or "
                f"register a different FileSystem for this scheme "
                f"(paddle_tpu_torch.utils.fs.register_fs)") from e
        except subprocess.CalledProcessError as e:
            stderr = (e.stderr or b"").decode(errors="replace")
            msg = (f"ShellFS: {self.command} fs {' '.join(args)} failed "
                   f"(rc={e.returncode}): {stderr[:500]}")
            low = stderr.lower()
            if any(m in low for m in _PERMANENT_MARKERS):
                raise PermanentFSError(msg) from e
            if any(m in low for m in _TRANSIENT_MARKERS):
                raise TransientFSError(msg) from e
            # rc=1 with silent stderr is the CLI's semantic "false"
            # (-test on a missing path) — retrying cannot change it
            if e.returncode == 1 and not stderr.strip():
                raise PermanentFSError(msg) from e
            raise TransientFSError(msg) from e

    def _run(self, *args, input_bytes=None, capture=True):
        return retry_call("shell_run", self._run_once, *args,
                          input_bytes=input_bytes, capture=capture)

    def open_read(self, path):
        out = self._run("-cat", path)
        return io.BytesIO(out.stdout)

    def open_write(self, path):
        fs = self

        class _Buf(io.BytesIO):
            def close(self_inner):
                data = self_inner.getvalue()
                fs._run("-put", "-f", "-", path, input_bytes=data)
                super().close()

        return _Buf()

    def exists(self, path):
        try:
            self._run("-test", "-e", path)
            return True
        except PermanentFSError:
            return False

    def mkdir(self, path):
        self._run("-mkdir", "-p", path)

    def remove(self, path):
        self._run("-rm", "-r", "-f", path)

    def list(self, path):
        out = self._run("-ls", path).stdout.decode(errors="replace")
        names = []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) >= 8:
                names.append(parts[-1].rsplit("/", 1)[-1])
        return sorted(names)

    def mv(self, src, dst):
        # HDFS rename refuses to overwrite; emulate os.replace with a
        # delete-then-rename (weaker atomicity than LocalFS — the window
        # between rm and mv can leave no meta; readers treat a missing
        # meta as 'no checkpoint yet', which the resume path tolerates)
        try:
            self._run("-rm", "-f", dst)
        except FSError:
            pass
        try:
            self._run("-mv", src, dst)
        except FSError:
            # rename is NOT idempotent: a timed-out attempt may have
            # committed server-side, making the retry fail with 'no such
            # file' — verify the outcome before reporting failure
            try:
                if not self.exists(src) and self.exists(dst):
                    return
            except FSError:
                pass
            raise


_REGISTRY: Dict[str, FileSystem] = {}
_LOCAL = LocalFS()


def register_fs(scheme: str, fs: FileSystem, retry: bool = False) -> None:
    """Register a filesystem for a path scheme (``'hdfs'``, ``'s3'``...).

    ``retry=True`` wraps it in :class:`RetryingFS` so transient failures
    back off and retry under the FLAGS_fs_retry_* budget."""
    if retry:
        fs = RetryingFS(fs)
    _REGISTRY[scheme.rstrip(":/")] = fs


register_fs("hdfs", ShellFS("hadoop"))
register_fs("afs", ShellFS("hadoop"))


def get_fs(path: str) -> FileSystem:
    """fs_select_internal parity: pick the filesystem by path prefix."""
    if "://" in path:
        scheme = path.split("://", 1)[0]
        fs = _REGISTRY.get(scheme)
        if fs is None:
            raise ValueError(
                f"no FileSystem registered for scheme '{scheme}://' — "
                f"register one with paddle_tpu_torch.utils.fs.register_fs")
        return fs
    return _LOCAL


def open_read(path: str):
    return get_fs(path).open_read(path)


def open_write(path: str):
    return get_fs(path).open_write(path)


def exists(path: str) -> bool:
    return get_fs(path).exists(path)


def write_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via tmp-file + rename so a crash
    mid-write never leaves a truncated artifact (true atomicity on
    LocalFS os.replace; best-effort delete+rename on ShellFS)."""
    fs = get_fs(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with fs.open_write(tmp) as f:
        f.write(data)
    try:
        fs.mv(tmp, path)
    except BaseException:
        try:
            fs.remove(tmp)
        except Exception:
            pass
        raise
