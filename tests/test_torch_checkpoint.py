"""paddle_tpu_torch's SnapshotStore held to paddle_tpu's on the CPU.

The SnapshotStore cases of ``tests/test_fault_tolerance.py`` (digests
and ``keep_max`` pruning, fallback past a corrupt snapshot, a missing
file never part-loading, an object never saved, a v1 meta, a failed
background publish), ``tests/test_hotswap.py`` (the payload round trip)
and ``tests/test_utils_extras.py`` (a resume), each run on both
packages with ``Linear`` layers holding the same numpy weights.  The
two packages write the same wire format, so the published metas —
digests included — must be equal, and so must the fault points, the
verdicts and the restored weights (exactly).

Not twinned: the ``TrainEpochRange`` / ``train_epoch_range`` loops, the
preemption handler and the sharded ``shard_state`` protocol (ROADMAP
A6); the cases here drive the store those loops sit on directly.
"""
import json
import os
import types
import warnings

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.testing import fault as jax_fault
from paddle_tpu.utils import checkpoint as jax_ckpt
from paddle_tpu.utils import monitor as jax_monitor
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.testing import fault as port_fault
from paddle_tpu_torch.utils import checkpoint as port_ckpt
from paddle_tpu_torch.utils import monitor as port_monitor


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    jax_monitor.stat_reset()
    port_monitor.stat_reset()
    yield
    placement.set_default(prev)


PKGS = {
    "jax": types.SimpleNamespace(pkg=paddle_tpu, ckpt=jax_ckpt,
                                 fault=jax_fault, monitor=jax_monitor),
    "port": types.SimpleNamespace(pkg=paddle_tpu_torch, ckpt=port_ckpt,
                                  fault=port_fault, monitor=port_monitor),
}


def _weights(seed):
    rs = np.random.RandomState(seed)
    return {"weight": rs.randn(3, 2).astype(np.float32),
            "bias": rs.randn(2).astype(np.float32)}


def _linear(side, seed):
    lin = side.pkg.nn.Linear(3, 2)
    lin.set_state_dict(_weights(seed))
    return lin


def _np(layer):
    return {k: np.array(v.numpy()) for k, v in layer.state_dict().items()}


def _save_epochs(side, d, epochs, keep_max):
    """One snapshot an epoch of a Linear whose weights move by one each
    epoch; returns the store and the layer."""
    store = side.ckpt.SnapshotStore(d, keep_max=keep_max)
    lin = _linear(side, 0)
    for e in range(epochs):
        lin.set_state_dict({k: v + 1.0 for k, v in _np(lin).items()})
        store.save(e, {"model": lin})
    return store, lin


def _both(tmp_path, fn):
    return {name: fn(side, str(tmp_path / name))
            for name, side in PKGS.items()}


def _meta(d):
    with open(os.path.join(d, "range_meta.json")) as f:
        return json.load(f)


def test_meta_publishes_digests_and_keeps_k_snapshots(tmp_path):
    def run(side, d):
        _save_epochs(side, d, 4, keep_max=2)
        return _meta(d), sorted(x for x in os.listdir(d)
                                if x.startswith("epoch_"))
    got = _both(tmp_path, run)
    meta, dirs = got["port"]
    assert [s["epoch"] for s in meta["snapshots"]] == [2, 3]
    assert dirs == ["epoch_2", "epoch_3"]
    for s in meta["snapshots"]:
        assert set(s["digests"]) == {"model.pdparams"}
        assert all(len(h) == 64 for h in s["digests"].values())
    # one wire format: the metas are equal, sha256 digests and all
    assert got["port"] == got["jax"]


def test_keep_max_defaults_to_the_flag(tmp_path):
    def run(side, d):
        old = side.pkg.get_flags(["checkpoint_keep_max"])
        side.pkg.set_flags({"checkpoint_keep_max": 3})
        try:
            store = side.ckpt.SnapshotStore(d)
        finally:
            side.pkg.set_flags(old)
        return store.keep_max
    assert _both(tmp_path, run) == {"jax": 3, "port": 3}


def test_corrupt_latest_falls_back_to_previous_intact(tmp_path):
    def run(side, d):
        _save_epochs(side, d, 2, keep_max=3)
        with open(os.path.join(d, "epoch_1", "model.pdparams"), "r+b") as f:
            f.write(b"GARBAGE!")
        lin = _linear(side, 99)
        with pytest.warns(UserWarning, match="sha256 mismatch"):
            nxt = side.ckpt.SnapshotStore(d).restore({"model": lin})
        return (nxt, side.monitor.get_stat("checkpoint.fallbacks"),
                side.monitor.get_stat("checkpoint.restores"), _np(lin))
    got = _both(tmp_path, run)
    nxt, fallbacks, restores, w = got["port"]
    assert (nxt, fallbacks, restores) == (1, 1, 1)   # epoch_0 -> resume at 1
    np.testing.assert_array_equal(w["weight"], _weights(0)["weight"] + 1.0)
    assert got["port"][:3] == got["jax"][:3]
    for k in w:
        np.testing.assert_array_equal(w[k], got["jax"][3][k])


def test_missing_snapshot_file_never_part_loads(tmp_path):
    def run(side, d):
        store = side.ckpt.SnapshotStore(d, keep_max=1)
        store.save(0, {"model": _linear(side, 0), "opt": _linear(side, 1)})
        os.remove(os.path.join(d, "epoch_0", "opt.pdparams"))
        model, opt = _linear(side, 98), _linear(side, 99)
        with pytest.raises(side.ckpt.CheckpointError,
                           match="no intact snapshot"):
            with pytest.warns(UserWarning):
                store.restore({"model": model, "opt": opt})
        return _np(model)
    got = _both(tmp_path, run)
    # nothing was applied to the registered objects
    for name in got:
        np.testing.assert_array_equal(got[name]["weight"],
                                      _weights(98)["weight"])


def test_object_registered_but_never_saved_is_loud(tmp_path):
    def run(side, d):
        store = side.ckpt.SnapshotStore(d, keep_max=1)
        store.save(0, {"model": _linear(side, 0)})
        with pytest.raises(side.ckpt.CheckpointError):
            with pytest.warns(UserWarning, match="never saved"):
                store.restore({"model": _linear(side, 1),
                               "ema": _linear(side, 2)})
        return side.monitor.get_stat("checkpoint.fallbacks")
    assert _both(tmp_path, run) == {"jax": 1, "port": 1}


def test_v1_meta_without_digests_still_restores(tmp_path):
    def run(side, d):
        store, lin = _save_epochs(side, d, 2, keep_max=1)
        with open(os.path.join(d, "range_meta.json"), "w") as f:
            json.dump({"finished_epoch": 1, "snapshot": "epoch_1",
                       "objects": ["model"]}, f)
        fresh = _linear(side, 99)
        return store.restore({"model": fresh}), _np(fresh), _np(lin)
    for nxt, got, want in _both(tmp_path, run).values():
        assert nxt == 2
        np.testing.assert_array_equal(got["weight"], want["weight"])


def test_step_snapshot_resumes_mid_epoch(tmp_path):
    """A step snapshot mid-epoch E publishes E - 1 as finished and
    restores to re-enter E, its step on ``last_restored`` (the cadence
    tier of ``tests/test_fault_tolerance.py``)."""
    def run(side, d):
        store = side.ckpt.SnapshotStore(d, keep_max=2)
        store.save(2, {"model": _linear(side, 0)}, step=17, kind="step")
        meta = _meta(d)
        nxt = side.ckpt.SnapshotStore(d).restore({"model": _linear(side, 1)})
        return meta, nxt
    got = _both(tmp_path, run)
    meta, nxt = got["port"]
    assert meta["finished_epoch"] == 1 and meta["snapshot"] == "step_17"
    assert meta["snapshots"][-1]["step"] == 17
    assert nxt == 2
    assert got["port"] == got["jax"]


def test_async_publish_failure_warns_and_keeps_older_snapshot(tmp_path):
    def run(side, d):
        store = side.ckpt.SnapshotStore(d)
        lin = _linear(side, 0)
        store.save(0, {"model": lin})
        w0 = _np(lin)
        lin.set_state_dict({k: v + 1.0 for k, v in w0.items()})
        with side.fault.inject("fs.open_write:count=1,exc=OSError,"
                               "match=step_7"):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                store.save_async(0, {"model": lin}, step=7)
                assert store.flush(timeout=30)
        fresh = _linear(side, 99)
        nxt = store.restore({"model": fresh})
        return (side.monitor.get_stat("checkpoint.async_errors"), nxt,
                store.last_restored["dir"], _np(fresh), w0)
    got = _both(tmp_path, run)
    for errors, nxt, snap, w, w0 in got.values():
        assert (errors, nxt, snap) == (1, 1, "epoch_0")
        np.testing.assert_array_equal(w["weight"], w0["weight"])


def test_async_publishes_land_in_order(tmp_path):
    def run(side, d):
        store = side.ckpt.SnapshotStore(d, keep_max=3)
        lin = _linear(side, 0)
        for s in (1, 2, 3):
            store.save_async(0, {"model": lin}, step=s)
        assert store.flush(timeout=30)
        return _meta(d), side.monitor.get_stat("checkpoint.async_saves")
    got = _both(tmp_path, run)
    meta, saves = got["port"]
    assert [s["step"] for s in meta["snapshots"]] == [1, 2, 3]
    assert saves == 3
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("point", ["ckpt.save", "ckpt.publish"])
def test_save_fault_points_leave_the_published_meta(tmp_path, point):
    """A fault at ``ckpt.save`` (before the capture) or ``ckpt.publish``
    (after the payloads, before the meta) leaves the meta at the last
    good snapshot on both packages."""
    def run(side, d):
        store = side.ckpt.SnapshotStore(d, keep_max=3)
        store.save(0, {"model": _linear(side, 0)})
        with side.fault.inject(f"{point}:count=1"):
            with pytest.raises(side.fault.FaultInjected):
                store.save(1, {"model": _linear(side, 1)})
        return _meta(d), side.monitor.get_stat(f"fault.fired.{point}")
    got = _both(tmp_path, run)
    meta, fired = got["port"]
    assert [s["dir"] for s in meta["snapshots"]] == ["epoch_0"]
    assert fired == 1
    assert got["port"] == got["jax"]


def test_restore_fault_point_fires_once_a_snapshot(tmp_path):
    def run(side, d):
        store, _ = _save_epochs(side, d, 2, keep_max=2)
        with side.fault.inject("ckpt.restore:count=1"):
            with pytest.raises(side.fault.FaultInjected):
                store.restore({"model": _linear(side, 9)})
        # disarmed: the same store restores
        return store.restore({"model": _linear(side, 9)})
    assert _both(tmp_path, run) == {"jax": 2, "port": 2}


def test_publish_payload_roundtrip(tmp_path):
    """latest_snapshot / load_payloads: the serving side's poll and
    verified read, and a flipped byte refused without raising."""
    def run(side, d):
        store = side.ckpt.SnapshotStore(d)
        assert store.latest_snapshot() is None
        params = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "b": np.ones(4, np.int32)}

        class Obj:
            def state_dict(self):
                return params
        store.save(0, {"serving_params": Obj()}, step=3, kind="step")
        snap = store.latest_snapshot()
        got = store.load_payloads(["serving_params"], snap)
        path = os.path.join(d, snap["dir"], "serving_params.pdparams")
        with open(path, "r+b") as f:
            f.seek(20)
            b = f.read(1)
            f.seek(20)
            f.write(bytes([b[0] ^ 0xFF]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            bad = store.load_payloads(["serving_params"])
        return snap, {k: np.asarray(v) for k, v in
                      got["serving_params"].items()}, bad
    got = _both(tmp_path, run)
    snap, payload, bad = got["port"]
    assert snap["step"] == 3 and bad is None
    np.testing.assert_array_equal(payload["a"],
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    assert payload["b"].dtype == np.int32
    assert snap == got["jax"][0]


def test_resume_across_stores(tmp_path):
    """A fresh store over a directory another process wrote resumes its
    newest snapshot (``test_utils_extras``' resume, on the store)."""
    def run(side, d):
        _save_epochs(side, d, 3, keep_max=2)
        fresh = _linear(side, 5)
        store = side.ckpt.SnapshotStore(d)
        return store.restore({"model": fresh}), store.last_restored, \
            _np(fresh)
    got = _both(tmp_path, run)
    assert got["port"][0] == got["jax"][0] == 3
    assert got["port"][1] == got["jax"][1]
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(got["port"][2][k], got["jax"][2][k])
        np.testing.assert_array_equal(got["port"][2][k],
                                      _weights(0)[k] + 3.0)


def test_a_store_written_by_one_package_restores_in_the_other(tmp_path):
    d = str(tmp_path / "shared")
    _save_epochs(PKGS["jax"], d, 2, keep_max=2)
    lin = _linear(PKGS["port"], 9)
    assert port_ckpt.SnapshotStore(d).restore({"model": lin}) == 2
    np.testing.assert_array_equal(_np(lin)["weight"],
                                  _weights(0)["weight"] + 2.0)


def test_scheme_paths_are_not_ported():
    with pytest.raises(NotImplementedError, match="A6"):
        port_ckpt.SnapshotStore("hdfs://cluster/ckpt")


def test_tracer_sees_saves_fallbacks_and_restores(tmp_path):
    from paddle_tpu_torch import observability as obs
    t = obs.enable()
    try:
        d = str(tmp_path / "t")
        _save_epochs(PKGS["port"], d, 2, keep_max=2)
        with open(os.path.join(d, "epoch_1", "model.pdparams"), "r+b") as f:
            f.write(b"GARBAGE!")
        with pytest.warns(UserWarning):
            port_ckpt.SnapshotStore(d).restore(
                {"model": _linear(PKGS["port"], 1)})
        names = [e["name"] for e in t.events() if e["kind"] == "checkpoint"]
        assert names == ["save", "save", "fallback", "restore"]
    finally:
        obs.disable()
