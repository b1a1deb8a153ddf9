"""``utils.fs`` and ``utils.crypto`` held to paddle_tpu's: the twins of
``tests/test_fs_crypto.py`` and of the filesystem cases of
``tests/test_fault_tolerance.py`` (the retry loop, ShellFS against a
fake ``hadoop`` CLI, the atomic ``save``, the ENOSPC/EROFS classification).

Every case runs on both packages (``side``) with the same inputs; the
saved artifacts cross between the packages, so the wire formats (plain
and encrypted) are held equal, bit for bit where a file is compared."""
import io
import os
import stat as stat_mod
import time
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn, optimizer as jopt
from paddle_tpu.testing import fault as jfault
from paddle_tpu.utils import checkpoint as jckpt
from paddle_tpu.utils import crypto as jcrypto, fs as jfs, monitor as jmon

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn, optimizer as topt
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.testing import fault as tfault
from paddle_tpu_torch.utils import checkpoint as tckpt
from paddle_tpu_torch.utils import crypto as tcrypto, fs as tfs
from paddle_tpu_torch.utils import monitor as tmon

SIDES = {
    "jax": SimpleNamespace(paddle=jpaddle, nn=jnn, optimizer=jopt,
                           fault=jfault, fs=jfs, crypto=jcrypto,
                           monitor=jmon, ckpt=jckpt),
    "torch": SimpleNamespace(paddle=tpaddle, nn=tnn, optimizer=topt,
                             fault=tfault, fs=tfs, crypto=tcrypto,
                             monitor=tmon, ckpt=tckpt)}
FLAGS = ["fs_retry_times", "fs_retry_deadline_s", "fs_retry_backoff_s"]


@pytest.fixture(autouse=True)
def _clean():
    tpaddle.set_device("cpu")
    saved = {k: (s.paddle.get_flags([k])[k]) for k in FLAGS
             for s in SIDES.values()}
    for s in SIDES.values():
        s.fault.disarm()
        s.monitor.stat_reset()
    yield
    for s in SIDES.values():
        s.fault.disarm()
        s.paddle.set_flags(saved)
    placement.set_default(None)


def _np(t):
    return np.asarray(t.numpy())


class MemFS:
    """An in-memory store standing in for a remote one (made a
    ``FileSystem`` of either package by :func:`_memfs`)."""

    def __init__(self):
        self.files = {}
        self.dirs = set()

    def open_read(self, path):
        if path not in self.files:
            raise OSError(f"no such file {path}")
        return io.BytesIO(self.files[path])

    def open_write(self, path):
        files = self.files

        class _B(io.BytesIO):
            def close(s):
                files[path] = s.getvalue()
                super().close()

        return _B()

    def exists(self, path):
        return path in self.files or path in self.dirs

    def mkdir(self, path):
        self.dirs.add(path)

    def remove(self, path):
        self.files = {k: v for k, v in self.files.items()
                      if not k.startswith(path)}
        self.dirs.discard(path)

    def list(self, path):
        out = set()
        for k in set(self.files) | self.dirs:
            if k.startswith(path.rstrip("/") + "/"):
                out.add(k[len(path.rstrip("/")) + 1:].split("/")[0])
        return sorted(out)

    def mv(self, src, dst):
        self.files[dst] = self.files.pop(src)


@pytest.fixture()
def memfs():
    """One store registered as ``mem://`` in both packages."""
    store = MemFS()
    for s in SIDES.values():
        cls = type("MemFS", (MemFS, s.fs.FileSystem), {})
        m = cls.__new__(cls)
        m.__dict__ = store.__dict__
        s.fs.register_fs("mem", m)
    yield store
    for s in SIDES.values():
        s.fs._REGISTRY.pop("mem", None)


def _linear_weights(seed):
    r = np.random.RandomState(seed)
    return {"weight": r.randn(4, 3).astype(np.float32),
            "bias": r.randn(3).astype(np.float32)}


def _linear(s, w):
    net = s.nn.Linear(4, 3)
    net.set_state_dict({k: s.paddle.to_tensor(v) for k, v in w.items()})
    return net


# -- test_fs_crypto twins ----------------------------------------------------
@pytest.mark.parametrize("side", sorted(SIDES))
def test_save_load_through_registered_fs(memfs, side):
    s = SIDES[side]
    w = _linear_weights(1)
    s.paddle.save(_linear(s, w).state_dict(), f"mem://{side}/m.pdparams")
    assert f"mem://{side}/m.pdparams" in memfs.files
    loaded = s.paddle.load(f"mem://{side}/m.pdparams")
    np.testing.assert_array_equal(_np(loaded["weight"]), w["weight"])


def test_registered_fs_bytes_cross_packages(memfs):
    """The port's ``save`` through a scheme writes the bytes paddle_tpu
    writes, and each package loads the other's."""
    w = _linear_weights(2)
    for side, s in SIDES.items():
        s.paddle.save(_linear(s, w).state_dict(), f"mem://x/{side}")
    assert memfs.files["mem://x/jax"] == memfs.files["mem://x/torch"]
    got = tpaddle.load("mem://x/jax")
    np.testing.assert_array_equal(_np(got["bias"]), w["bias"])
    got = jpaddle.load("mem://x/torch")
    np.testing.assert_array_equal(_np(got["weight"]), w["weight"])


@pytest.mark.parametrize("side", sorted(SIDES))
def test_train_epoch_range_on_remote_fs(memfs, side):
    """Snapshot, 'crash' during epoch 2, resume from epoch 1's snapshot
    through a registered store."""
    s = SIDES[side]
    net = _linear(s, _linear_weights(80))
    opt = s.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    w_published = None
    for epoch in s.ckpt.TrainEpochRange(5, f"mem://jobs/{side}", model=net,
                                        opt=opt):
        net.weight.data = net.weight.data + 1.0
        if epoch == 1:
            w_published = _np(net.weight).copy()
        if epoch == 2:
            break
    net2 = _linear(s, _linear_weights(81))
    opt2 = s.optimizer.SGD(learning_rate=0.1, parameters=net2.parameters())
    r2 = s.ckpt.TrainEpochRange(5, f"mem://jobs/{side}", model=net2,
                                opt=opt2)
    assert [e for e in r2] == [2, 3, 4]
    np.testing.assert_array_equal(_np(net2.weight), w_published)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_unregistered_scheme_is_loud(side):
    with pytest.raises(ValueError, match="register_fs"):
        SIDES[side].fs.get_fs("s3://bucket/x")


@pytest.mark.parametrize("side", sorted(SIDES))
def test_shellfs_missing_cli_is_loud(side):
    sf = SIDES[side].fs.ShellFS("definitely_not_a_real_binary_xyz")
    with pytest.raises(RuntimeError, match="CLI not found"):
        sf.open_read("hdfs://x/y")


@pytest.mark.parametrize("side", sorted(SIDES))
def test_encrypted_save_load_roundtrip(tmp_path, side):
    s = SIDES[side]
    w = _linear_weights(3)
    p = str(tmp_path / "enc.pdparams")
    s.paddle.save(_linear(s, w).state_dict(), p, encryption_key="secret")
    raw = open(p, "rb").read()
    assert s.crypto.is_encrypted(raw[:8])
    assert w["weight"].tobytes()[:16] not in raw
    loaded = s.paddle.load(p, encryption_key="secret")
    np.testing.assert_array_equal(_np(loaded["weight"]), w["weight"])


def test_encrypted_files_cross_packages(tmp_path):
    w = _linear_weights(4)
    for side, s in SIDES.items():
        s.paddle.save(_linear(s, w).state_dict(),
                      str(tmp_path / f"{side}.enc"), encryption_key="k")
    out = tpaddle.load(str(tmp_path / "jax.enc"), encryption_key="k")
    np.testing.assert_array_equal(_np(out["weight"]), w["weight"])
    out = jpaddle.load(str(tmp_path / "torch.enc"), encryption_key="k")
    np.testing.assert_array_equal(_np(out["bias"]), w["bias"])
    blob = tcrypto.encrypt(b"payload", "key")
    assert jcrypto.decrypt(blob, "key") == b"payload"


@pytest.mark.parametrize("side", sorted(SIDES))
def test_wrong_key_and_missing_key_are_loud(tmp_path, side):
    s = SIDES[side]
    p = str(tmp_path / "enc2.pdparams")
    s.paddle.save({"a": s.paddle.ones([2])}, p, encryption_key="k1")
    with pytest.raises(ValueError, match="encrypted"):
        s.paddle.load(p)
    with pytest.raises(ValueError, match="wrong key|corrupted"):
        s.paddle.load(p, encryption_key="k2")


@pytest.mark.parametrize("side", sorted(SIDES))
def test_key_file_flow(tmp_path, side):
    s = SIDES[side]
    kf = str(tmp_path / "model.key")
    key = s.crypto.generate_key_file(kf)
    assert len(key) == 32
    p = str(tmp_path / "enc3.pdparams")
    s.paddle.save({"a": s.paddle.ones([4])}, p,
                  encryption_key=open(kf, "rb").read())
    out = s.paddle.load(p, encryption_key=open(kf, "rb").read())
    np.testing.assert_array_equal(_np(out["a"]), 1.0)


# -- the retry loop (test_fault_tolerance.py's fs cases) ---------------------
@pytest.mark.parametrize("side", sorted(SIDES))
def test_fs_flake_is_retried_then_succeeds(tmp_path, side):
    s = SIDES[side]
    rfs = s.fs.RetryingFS(s.fs.LocalFS())
    p = str(tmp_path / "x.bin")
    with s.fault.inject("fs.open_write:count=2,exc=TransientFSError"):
        with rfs.open_write(p) as f:
            f.write(b"payload")
    assert open(p, "rb").read() == b"payload"
    assert s.monitor.get_stat("fs.retries") == 2
    assert s.monitor.get_stat("fs.gave_up") == 0


@pytest.mark.parametrize("side", sorted(SIDES))
def test_exhausted_retries_surface_classified_error(tmp_path, side):
    s = SIDES[side]
    s.paddle.set_flags({"fs_retry_times": 3, "fs_retry_backoff_s": 0.01})
    rfs = s.fs.RetryingFS(s.fs.LocalFS())
    with s.fault.inject("fs.open_write:exc=TransientFSError"):
        with pytest.raises(s.fs.TransientFSError):
            rfs.open_write(str(tmp_path / "y.bin"))
    assert s.monitor.get_stat("fs.retries") == 2
    assert s.monitor.get_stat("fs.gave_up") == 1


@pytest.mark.parametrize("side", sorted(SIDES))
def test_permanent_error_is_not_retried(tmp_path, side):
    s = SIDES[side]
    rfs = s.fs.RetryingFS(s.fs.LocalFS())
    with s.fault.inject("fs.open_read:exc=PermanentFSError"):
        with pytest.raises(s.fs.PermanentFSError):
            rfs.open_read(str(tmp_path / "absent.bin"))
    assert s.monitor.get_stat("fs.retries") == 0


@pytest.mark.parametrize("side", sorted(SIDES))
def test_retry_deadline_bounds_wall_clock(tmp_path, side):
    s = SIDES[side]
    s.paddle.set_flags({"fs_retry_times": 1000, "fs_retry_deadline_s": 0.2,
                        "fs_retry_backoff_s": 0.05})
    rfs = s.fs.RetryingFS(s.fs.LocalFS())
    t0 = time.monotonic()
    with s.fault.inject("fs.open_write:exc=TransientFSError"):
        with pytest.raises(s.fs.TransientFSError):
            rfs.open_write(str(tmp_path / "z.bin"))
    assert time.monotonic() - t0 < 5.0
    assert s.monitor.get_stat("fs.gave_up") == 1


@pytest.mark.parametrize("side", sorted(SIDES))
def test_retrying_decorator_and_classification(side):
    s = SIDES[side]
    s.paddle.set_flags({"fs_retry_backoff_s": 0.01})
    calls = []

    @s.fs.retrying("flaky_op")
    def flaky(x):
        calls.append(x)
        if len(calls) < 3:
            raise s.fs.TransientFSError("blip")
        return x * 2

    assert flaky(21) == 42 and len(calls) == 3
    assert s.monitor.get_stat("fs.retries") == 2
    cases = [s.fs.TransientFSError("x"), s.fs.PermanentFSError("x"),
             FileNotFoundError("x"), PermissionError("x"),
             ConnectionResetError("x"), TimeoutError("x"), ValueError("x")]
    assert [s.fs.is_transient(e) for e in cases] == [
        True, False, False, False, True, True, False]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_enospc_erofs_fail_fast_as_permanent(side):
    import errno as _errno
    s = SIDES[side]
    for eno in (_errno.ENOSPC, _errno.EROFS, _errno.EDQUOT):
        assert not s.fs.is_transient(OSError(eno, os.strerror(eno)))
    calls = []

    def nospace():
        calls.append(1)
        raise OSError(_errno.ENOSPC, "No space left on device")

    with pytest.raises(s.fs.PermanentFSError, match="ENOSPC"):
        s.fs.retry_call("open_write", nospace)
    assert len(calls) == 1
    assert s.monitor.get_stat("fs.retries") == 0
    assert s.monitor.get_stat("fs.permanent") == 1
    assert s.fs._PERMANENT_MARKERS == jfs._PERMANENT_MARKERS
    assert s.fs._TRANSIENT_MARKERS == jfs._TRANSIENT_MARKERS


# -- ShellFS against a fake hadoop CLI ---------------------------------------
_FAKE_HADOOP = r"""#!/usr/bin/env bash
# fake 'hadoop fs' CLI backed by $FAKE_HDFS_ROOT; while .flake_count > 0
# every call fails like a network blip
set -u
root="${FAKE_HDFS_ROOT:?}"
flake="$root/.flake_count"
if [ -f "$flake" ]; then
  n=$(cat "$flake")
  if [ "$n" -gt 0 ]; then
    echo $((n-1)) > "$flake"
    echo "java.net.ConnectException: Connection refused" >&2
    exit 255
  fi
fi
shift                       # 'fs'
verb="$1"; shift
map() { local p="${1#*://}"; echo "$root/$p"; }
case "$verb" in
  -cat)   cat "$(map "$1")" 2>/dev/null || {
            echo "cat: No such file or directory: $1" >&2; exit 1; };;
  -put)   shift; shift       # -f -
          dst="$(map "$1")"; mkdir -p "$(dirname "$dst")"; cat > "$dst";;
  -test)  [ -e "$(map "$2")" ];;
  -mkdir) mkdir -p "$(map "$2")";;
  -rm)    for last; do :; done; rm -rf "$(map "$last")";;
  -ls)    p="$(map "$1")"
          for f in "$p"/*; do
            [ -e "$f" ] || continue
            echo "-rw-r--r-- 1 u g 0 2024-01-01 00:00 hdfs://f/$(basename "$f")"
          done;;
  -mv)    mv "$(map "$1")" "$(map "$2")" || exit 1
          if [ -f "$root/.mv_commit_fail" ]; then
            rm -f "$root/.mv_commit_fail"
            echo "java.net.SocketTimeoutException: timed out" >&2
            exit 255
          fi;;
  *)      echo "unknown verb $verb" >&2; exit 2;;
esac
"""


@pytest.fixture()
def fake_hadoop(tmp_path, monkeypatch):
    root = tmp_path / "hdfs_root"
    root.mkdir()
    cli = tmp_path / "hadoop"
    cli.write_text(_FAKE_HADOOP)
    cli.chmod(cli.stat().st_mode | stat_mod.S_IEXEC)
    monkeypatch.setenv("FAKE_HDFS_ROOT", str(root))
    for s in SIDES.values():
        s.paddle.set_flags({"fs_retry_backoff_s": 0.01})
    return str(cli), root


@pytest.mark.parametrize("side", sorted(SIDES))
def test_shellfs_write_read_exists_list_mv(fake_hadoop, side):
    cli, root = fake_hadoop
    sfs = SIDES[side].fs.ShellFS(cli)
    with sfs.open_write("hdfs://job/a.bin") as f:
        f.write(b"hello hdfs")
    assert (root / "job" / "a.bin").read_bytes() == b"hello hdfs"
    assert sfs.exists("hdfs://job/a.bin")
    assert not sfs.exists("hdfs://job/missing.bin")
    with sfs.open_read("hdfs://job/a.bin") as f:
        assert f.read() == b"hello hdfs"
    sfs.mkdir("hdfs://job/sub")
    assert sfs.list("hdfs://job") == ["a.bin", "sub"]
    sfs.mv("hdfs://job/a.bin", "hdfs://job/b.bin")
    assert sfs.list("hdfs://job") == ["b.bin", "sub"]
    sfs.remove("hdfs://job/b.bin")
    assert not sfs.exists("hdfs://job/b.bin")


@pytest.mark.parametrize("side", sorted(SIDES))
def test_shellfs_transient_cli_failure_is_retried(fake_hadoop, side):
    cli, root = fake_hadoop
    s = SIDES[side]
    sfs = s.fs.ShellFS(cli)
    with sfs.open_write("hdfs://r/x.bin") as f:
        f.write(b"v1")
    (root / ".flake_count").write_text("2")
    with sfs.open_read("hdfs://r/x.bin") as f:
        assert f.read() == b"v1"
    assert s.monitor.get_stat("fs.retries") == 2


@pytest.mark.parametrize("side", sorted(SIDES))
def test_shellfs_gives_up_after_budget(fake_hadoop, side):
    cli, root = fake_hadoop
    s = SIDES[side]
    s.paddle.set_flags({"fs_retry_times": 2})
    (root / ".flake_count").write_text("99")
    with pytest.raises(s.fs.TransientFSError, match="Connection refused"):
        s.fs.ShellFS(cli).open_read("hdfs://r/x.bin")
    assert s.monitor.get_stat("fs.gave_up") == 1


@pytest.mark.parametrize("side", sorted(SIDES))
def test_shellfs_missing_file_is_permanent_not_retried(fake_hadoop, side):
    cli, _ = fake_hadoop
    s = SIDES[side]
    with pytest.raises(s.fs.PermanentFSError, match="No such file"):
        s.fs.ShellFS(cli).open_read("hdfs://r/never_written.bin")
    assert s.monitor.get_stat("fs.retries") == 0


@pytest.mark.parametrize("side", sorted(SIDES))
def test_shellfs_mv_commit_then_timeout_is_success(fake_hadoop, side):
    cli, root = fake_hadoop
    sfs = SIDES[side].fs.ShellFS(cli)
    with sfs.open_write("hdfs://j/meta.tmp") as f:
        f.write(b"meta")
    (root / ".mv_commit_fail").write_text("")
    sfs.mv("hdfs://j/meta.tmp", "hdfs://j/meta.json")
    assert sfs.exists("hdfs://j/meta.json")
    assert not sfs.exists("hdfs://j/meta.tmp")


def test_save_load_roundtrip_through_fake_hdfs(fake_hadoop):
    """Each package saves through ShellFS; the other loads it."""
    cli, _ = fake_hadoop
    for s in SIDES.values():
        s.fs.register_fs("fakehdfs", s.fs.ShellFS(cli))
    try:
        for side, s in SIDES.items():
            s.paddle.save({"w": s.paddle.ones([3, 2])},
                          f"fakehdfs://m/{side}.pdparams")
        out = tpaddle.load("fakehdfs://m/jax.pdparams")
        np.testing.assert_array_equal(_np(out["w"]), 1.0)
        out = jpaddle.load("fakehdfs://m/torch.pdparams")
        np.testing.assert_array_equal(_np(out["w"]), 1.0)
    finally:
        for s in SIDES.values():
            s.fs._REGISTRY.pop("fakehdfs", None)


# -- the atomic save ---------------------------------------------------------
@pytest.mark.parametrize("side", sorted(SIDES))
def test_save_is_atomic_crash_leaves_no_truncated_file(tmp_path, side):
    s = SIDES[side]
    p = str(tmp_path / "m.pdparams")
    s.paddle.save({"a": s.paddle.ones([2])}, p)
    v1 = open(p, "rb").read()
    with s.fault.inject("fs.mv:count=1"):
        with pytest.raises(s.fault.FaultInjected):
            s.paddle.save({"a": s.paddle.zeros([64, 64])}, p)
    assert open(p, "rb").read() == v1
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []
    np.testing.assert_array_equal(_np(s.paddle.load(p)["a"]), 1.0)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_save_crash_before_write_leaves_nothing(tmp_path, side):
    s = SIDES[side]
    p = str(tmp_path / "fresh.pdparams")
    with s.fault.inject("fs.open_write:count=1"):
        with pytest.raises(s.fault.FaultInjected):
            s.paddle.save({"a": s.paddle.ones([2])}, p)
    assert not os.path.exists(p)
