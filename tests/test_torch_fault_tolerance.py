"""Fault tolerance held to paddle_tpu (the twins of the A5c cases of
``tests/test_fault_tolerance.py``): the fault framework (the disarmed
point, spec parsing, the seeded probability, ``arm_from_flags``, the
sleep action, the executor's points), ``TrainEpochRange``'s SIGTERM
save at the epoch and at the step boundary and its step-cadence resume,
the heartbeat, the watchdog, the Executor's stamp, and the
``TrainingSupervisor``'s restart, crash loop, give-up flight, hang kill,
restart-recompile rule and the supervised drill.

The pure-logic cases run on both packages and compare; the cases that
spawn supervised children, deliver signals or train eager layers run
the port (``set_device("cpu")``).  The filesystem, shell-filesystem,
DataLoader and hapi-callback cases are in ``test_torch_fs_crypto.py``,
``test_torch_dataloader_mp.py``, ``test_torch_io.py`` and
``test_torch_hapi.py``.

Process cases give every timed clock a margin: the restart-recompile
case's first child beats at step scale against a 1.5 s floor, and its
second stays silent for 3.5 s, so a loaded host (tier-1 runs
``-n 6``) cannot turn a slow beat into a hang kill.
"""
import json
import os
import signal
import time

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.testing import fault as jfault
from paddle_tpu.utils import monitor as jmonitor

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.testing import fault as tfault
from paddle_tpu_torch.utils import monitor as tmonitor
from paddle_tpu_torch.utils.checkpoint import (SnapshotStore,
                                               TrainEpochRange,
                                               install_preemption_handler)

SIDES = {"jax": (jpaddle, jfault, jmonitor),
         "torch": (tpaddle, tfault, tmonitor)}


@pytest.fixture(autouse=True)
def _clean_chaos():
    for _, fault, monitor in SIDES.values():
        fault.disarm()
        monitor.stat_reset()
    tpaddle.set_device("cpu")
    yield
    for _, fault, _ in SIDES.values():
        fault.disarm()
    placement.set_default(None)


# -- fault framework ---------------------------------------------------------
@pytest.mark.parametrize("side", sorted(SIDES))
def test_disarmed_point_is_noop_and_adds_no_stats(side):
    _, fault, monitor = SIDES[side]
    fault.point("fs.open_write", "/nowhere")
    fault.point("anything.at.all")
    assert not fault.is_armed()
    assert not any(k.startswith("fault.") for k in monitor.all_stats())


@pytest.mark.parametrize("side", sorted(SIDES))
def test_spec_parse_count_match_exc_and_fire_stats(side):
    _, fault, monitor = SIDES[side]
    with fault.inject("ckpt.save:count=2,exc=OSError,match=special"):
        fault.point("ckpt.save", "/tmp/plain")       # no 'special': quiet
        with pytest.raises(OSError, match="injected fault"):
            fault.point("ckpt.save", "/tmp/special")
        assert fault.fire_count("ckpt.save") == 1
    assert monitor.get_stat("fault.fired.ckpt.save") == 1
    assert not fault.is_armed()          # inject() restored disarmed


def _fired(fault, seed):
    fired = []
    with fault.inject("p.x:p=0.5", seed=seed):
        for _ in range(32):
            try:
                fault.point("p.x")
                fired.append(0)
            except fault.FaultInjected:
                fired.append(1)
    return fired


def test_probability_is_seed_deterministic():
    """Both packages draw ``p`` from ``random.Random(seed)``: the same
    fires for the same seed, on either side."""
    a, b, c = (_fired(tfault, s) for s in (11, 11, 12))
    assert a == b and a != c and 0 < sum(a) < 32
    assert a == _fired(jfault, 11)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_arm_from_flags_roundtrip(side):
    pkg, fault, _ = SIDES[side]
    pkg.set_flags({"fault_spec": "flag.pt:count=1", "fault_seed": 3})
    try:
        assert fault.arm_from_flags()
        with pytest.raises(fault.FaultInjected):
            fault.point("flag.pt")
        fault.point("flag.pt")           # count exhausted
    finally:
        pkg.set_flags({"fault_spec": ""})
        fault.disarm()


def test_spec_for_children_respawn_filter():
    for _, fault, _ in SIDES.values():
        fault.arm("a.b:count=1,action=exit,code=9;c.d:respawn=1", seed=4)
        spec, seed = fault.spec_for_children()
        assert seed == 4 and spec.split(";")[0] == \
            "a.b:count=1,action=exit,code=9"
        assert fault.spec_for_children(respawn=True) == ("c.d:respawn=1", 4)
        fault.disarm()
        assert fault.spec_for_children() is None


@pytest.mark.parametrize("side", sorted(SIDES))
def test_sleep_fault_action_wedges_then_returns(side):
    _, fault, monitor = SIDES[side]
    t0 = time.monotonic()
    with fault.inject("slow.point:action=sleep,secs=0.15,count=1"):
        fault.point("slow.point")            # wedges ~0.15s, returns
        fault.point("slow.point")            # count exhausted: instant
    assert time.monotonic() - t0 >= 0.15
    assert monitor.get_stat("fault.fired.slow.point") == 1
    r = fault.parse_spec("x.y:action=sleep,secs=2.5")[0]
    assert r.action == "sleep" and r.secs == 2.5
    assert "secs=2.5" in r.to_spec()         # survives child re-arming


# -- the executor's points ---------------------------------------------------
def _sum_program(pkg):
    with pkg.static.program_guard(pkg.static.Program()) as main:
        x = pkg.static.data("x", [None, 2], "float32")
        out = x.sum(axis=1)
    return main, out


@pytest.mark.parametrize("side", sorted(SIDES))
def test_executor_run_fault_point(side):
    pkg, fault, _ = SIDES[side]
    pkg.enable_static()
    try:
        main, out = _sum_program(pkg)
        exe = pkg.static.Executor()
        arr = np.ones((2, 2), np.float32)
        with fault.inject("executor.run:count=1"):
            with pytest.raises(fault.FaultInjected):
                exe.run(main, feed={"x": arr}, fetch_list=[out])
            res, = exe.run(main, feed={"x": arr}, fetch_list=[out])
        np.testing.assert_allclose(res, [2.0, 2.0])
    finally:
        pkg.disable_static()
        pkg.static.reset_default_programs()


def test_executor_step_hang_point_names_the_run():
    """``executor.step_hang`` fires once a run, after the run counter
    moves, with ``step=<run>`` in its detail (a sleep rule there is the
    supervisor drills' hang)."""
    tpaddle.enable_static()
    try:
        main, out = _sum_program(tpaddle)
        exe = tpaddle.static.Executor()
        arr = np.ones((2, 2), np.float32)
        with tfault.inject("executor.step_hang:count=1,match=step=2"):
            exe.run(main, feed={"x": arr}, fetch_list=[out])
            with pytest.raises(tfault.FaultInjected, match="step=2"):
                exe.run(main, feed={"x": arr}, fetch_list=[out])
            exe.run(main, feed={"x": arr}, fetch_list=[out])
    finally:
        tpaddle.disable_static()
        tpaddle.static.reset_default_programs()


# -- TrainEpochRange ---------------------------------------------------------
def _mk(seed):
    tpaddle.seed(seed)
    net = nn.Linear(2, 2)
    opt = optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    return net, opt


def _run_epochs(d, n_stop, total=6, seed=0, **range_kw):
    net, opt = _mk(seed)
    r = TrainEpochRange(total, d, model=net, opt=opt, **range_kw)
    for e in r:
        net.weight.data = net.weight.data + 1.0
        if e == n_stop:
            break
    return net


def test_sigterm_saves_at_boundary_and_fresh_range_resumes(tmp_path):
    d = str(tmp_path / "acp")
    net, opt = _mk(0)
    r = TrainEpochRange(6, d, save_checkpoint_inter=10, model=net,
                        opt=opt)
    done = []
    with pytest.raises(SystemExit) as ei:
        for e in r:
            done.append(e)
            net.weight.data = net.weight.data + 1.0
            if e == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            # the body goes on: the save happens at the epoch boundary
    assert ei.value.code == 0
    assert done == [0, 1] and r.preempted
    assert tmonitor.get_stat("checkpoint.preempt_saves") == 1
    w_saved = net.weight.numpy().copy()
    net2, opt2 = _mk(99)
    r2 = TrainEpochRange(6, d, model=net2, opt=opt2)
    it = iter(r2)
    assert next(it) == 2
    np.testing.assert_array_equal(net2.weight.numpy(), w_saved)
    it.close()


def test_sigterm_handler_restored_after_iteration(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    net, opt = _mk(0)
    list(TrainEpochRange(2, str(tmp_path / "acp"), model=net, opt=opt))
    assert signal.getsignal(signal.SIGTERM) == prev
    # and the handler chains to the one it replaced
    seen = []
    old = signal.signal(signal.SIGTERM, lambda *a: seen.append("outer"))
    try:
        restore = install_preemption_handler(lambda: seen.append("inner"))
        os.kill(os.getpid(), signal.SIGTERM)
        restore()
        assert seen == ["inner", "outer"]
    finally:
        signal.signal(signal.SIGTERM, old)


def test_recovery_events_visible_in_monitor(tmp_path):
    _run_epochs(str(tmp_path / "acp"), 1)
    assert tmonitor.all_stats()["checkpoint.saves"] >= 1


def test_clean_run_has_no_fault_or_recovery_noise(tmp_path):
    _run_epochs(str(tmp_path / "acp"), 1)          # disarmed, healthy
    net2, opt2 = _mk(1)
    list(TrainEpochRange(3, str(tmp_path / "acp"), model=net2, opt=opt2))
    stats = tmonitor.all_stats()
    assert not any(k.startswith("fault.") for k in stats)
    assert stats.get("checkpoint.fallbacks", 0) == 0


def test_train_epoch_range_and_scheme_paths(tmp_path):
    """``train_epoch_range`` over a registered ``scheme://`` directory:
    the port's loop snapshots and resumes through the scheme's
    filesystem, and its published epochs are paddle_tpu's."""
    from paddle_tpu.utils import fs as jfs
    from paddle_tpu.utils import train_epoch_range as jrange
    from paddle_tpu_torch.utils import fs as tfs
    from paddle_tpu_torch.utils import train_epoch_range
    for fs in (jfs, tfs):
        fs.register_fs("pfx", fs.PrefixStripFS(fs.LocalFS(), "pfx"))
    try:
        metas = {}
        for name, rng_fn in (("jax", jrange), ("torch", train_epoch_range)):
            d = f"pfx://{tmp_path}/{name}"
            assert list(rng_fn(2, d)) == [0, 1]
            assert list(rng_fn(3, d)) == [2]
            metas[name] = json.load(open(tmp_path / name /
                                         "range_meta.json"))
        assert [s["epoch"] for s in metas["torch"]["snapshots"]] == \
            [s["epoch"] for s in metas["jax"]["snapshots"]]
        assert metas["torch"]["finished_epoch"] == 2 == \
            metas["jax"]["finished_epoch"]
    finally:
        for fs in (jfs, tfs):
            fs._REGISTRY.pop("pfx", None)


def _cadence_build(seed=1234):
    tpaddle.seed(seed)
    net = nn.Linear(4, 1)
    opt = optimizer.SGD(learning_rate=0.05, parameters=net.parameters())
    return net, opt


_CAD_X = np.random.RandomState(7).randn(32, 4).astype(np.float32)
_CAD_Y = _CAD_X @ np.random.RandomState(8).randn(4, 1).astype(np.float32)


def _cadence_step(net, opt):
    loss = TF.mse_loss(net(tpaddle.to_tensor(_CAD_X, place="cpu")),
                       tpaddle.to_tensor(_CAD_Y, place="cpu"))
    loss.backward()
    opt.step()
    opt.clear_grad()


def test_step_cadence_snapshots_resume_mid_epoch(tmp_path):
    d = str(tmp_path / "acp")
    net, opt = _cadence_build()
    r = TrainEpochRange(1, d, save_every_steps=3, model=net, opt=opt)
    weights = {}
    for _epoch in r:
        for _ in range(10):
            _cadence_step(net, opt)
            g = r.step()
            weights[g] = net.weight.numpy().copy()
            if g == 7:
                break                        # a crash mid-epoch
        break                                # (no epoch-boundary save)
    assert tmonitor.get_stat("checkpoint.step_saves") == 2     # 3 and 6
    meta = SnapshotStore(d).load_meta()
    assert meta["snapshots"][-1]["kind"] == "step"
    assert meta["snapshots"][-1]["step"] == 6
    assert meta["snapshots"][-1]["digests"]
    net2, opt2 = _cadence_build(99)
    r2 = TrainEpochRange(1, d, save_every_steps=3, model=net2, opt=opt2)
    it = iter(r2)
    assert next(it) == 0                     # mid-epoch: epoch 0 again
    assert r2.resume_step == 6
    np.testing.assert_array_equal(net2.weight.numpy(), weights[6])
    for g in range(r2.resume_step, 10):
        _cadence_step(net2, opt2)
        r2.step()
        if g + 1 in weights:
            np.testing.assert_array_equal(net2.weight.numpy(),
                                          weights[g + 1])
    it.close()


def test_sigterm_saves_at_step_boundary_not_epoch(tmp_path):
    d = str(tmp_path / "acp")
    net, opt = _cadence_build()
    r = TrainEpochRange(4, d, save_every_steps=100, model=net, opt=opt)
    with pytest.raises(SystemExit) as ei:
        for _epoch in r:
            for i in range(10):
                _cadence_step(net, opt)
                if i == 4:
                    os.kill(os.getpid(), signal.SIGTERM)
                r.step()                     # saves HERE, exits 0
            pytest.fail("step() should have exited at the boundary")
    assert ei.value.code == 0 and r.preempted
    assert tmonitor.get_stat("checkpoint.preempt_saves") == 1
    w_saved = net.weight.numpy().copy()
    last = SnapshotStore(d).load_meta()["snapshots"][-1]
    assert last["kind"] == "step" and last["step"] == 5
    net2, opt2 = _cadence_build(99)
    r2 = TrainEpochRange(4, d, model=net2, opt=opt2)
    it = iter(r2)
    assert next(it) == 0 and r2.resume_step == 5
    np.testing.assert_array_equal(net2.weight.numpy(), w_saved)
    it.close()


# -- heartbeat, watchdog, the Executor's stamp -------------------------------
def _sv(side):
    if side == "jax":
        from paddle_tpu.distributed import supervisor
    else:
        from paddle_tpu_torch.distributed import supervisor
    return supervisor


@pytest.mark.parametrize("side", sorted(SIDES))
def test_heartbeat_roundtrip_and_torn_write_guard(side, tmp_path):
    sv = _sv(side)
    p = str(tmp_path / "hb")
    w = sv.HeartbeatWriter(p)
    rd = sv.HeartbeatReader(p)
    assert sv.HeartbeatReader(str(tmp_path / "missing")).read() is None
    w.beat(-1)
    hb = rd.read()
    assert hb.step == -1 and hb.interval_s == 0.0
    w.beat(1, {"predicted_step_s": 0.25})
    time.sleep(0.02)
    w.beat(2, {"predicted_step_s": 0.25})
    hb = rd.read()
    assert hb.step == 2 and hb.predicted_step_s == 0.25
    assert 0.0 < hb.interval_s < 5.0
    w.beat(3, fresh_compile=True)
    assert rd.read().interval_s == 0.0
    with open(p, "r+b") as f:
        f.write(b"\xff" * 17)
    assert rd.read() is None
    w.close()
    rd.close()
    if side == "torch":
        # the record is the same bytes paddle_tpu's reader takes
        w = sv.HeartbeatWriter(p)
        w.beat(7, {"predicted_step_s": 0.5})
        hb = _sv("jax").HeartbeatReader(p).read()
        assert (hb.step, hb.predicted_step_s) == (7, 0.5)
        w.close()


def _watchdog_trace(sv):
    def hb(step, pred, interval):
        return sv.Heartbeat(time.time(), step, pred, interval)
    out = []
    wd = sv.StepWatchdog(multiplier=10.0, min_deadline_s=0.001,
                         max_deadline_s=1000.0, drift_cap=4.0)
    wd.observe(hb(1, 0.5, 0.5))
    out.append(wd.deadline_s())
    for i in range(2, 12):
        wd.observe(hb(i, 0.5, 1.5))
    out += [wd.drift(), wd.deadline_s()]
    for i in range(12, 40):
        wd.observe(hb(i, 0.5, 50.0))
    out.append(wd.drift())
    wd = sv.StepWatchdog(multiplier=4.0, min_deadline_s=0.001,
                         max_deadline_s=1000.0)
    for i, dt in enumerate([0.1] * 98 + [0.3] * 2):
        wd.observe(hb(i, None, dt))
    out.append(wd.deadline_s())
    n = len(wd._intervals)
    wd.observe(hb(99, None, 0.3))
    out.append(len(wd._intervals) - n)
    out.append(sv.StepWatchdog(min_deadline_s=1.0,
                               max_deadline_s=30.0).deadline_s())
    wd = sv.StepWatchdog(multiplier=8.0, min_deadline_s=5.0)
    wd.observe(hb(1, 1e-6, 1e-6))
    out.append(wd.deadline_s())
    with pytest.raises(ValueError):
        sv.StepWatchdog(min_deadline_s=2.0, max_deadline_s=1.0)
    return out


def test_watchdog_deadline_predicted_drift_and_p99_fallback():
    t = _watchdog_trace(_sv("torch"))
    assert t == _watchdog_trace(_sv("jax"))
    assert t[0] == pytest.approx(5.0) and t[1] == pytest.approx(3.0)
    assert t[2] == pytest.approx(15.0) and t[3] == 4.0
    assert t[4] == pytest.approx(1.2) and t[5] == 0
    assert t[6] == 30.0 and t[7] == 5.0


def test_executor_stamps_heartbeat_per_step(tmp_path):
    from paddle_tpu_torch.core import obs_hook
    from paddle_tpu_torch.distributed.supervisor import (HeartbeatReader,
                                                         HeartbeatWriter,
                                                         current_heartbeat)
    tpaddle.enable_static()
    try:
        main = tpaddle.static.Program()
        with tpaddle.static.program_guard(main):
            x = tpaddle.static.data("x", [None, 4], "float32")
            y = tpaddle.static.nn.fc(x, 2)
        exe = tpaddle.static.Executor()
        w = HeartbeatWriter(str(tmp_path / "hb"))
        obs_hook.set_heartbeat(w)
        try:
            assert current_heartbeat() is w
            feed = {"x": np.zeros((2, 4), np.float32)}
            for _ in range(3):
                exe.run(main, feed=feed, fetch_list=[y])
            hb = HeartbeatReader(str(tmp_path / "hb")).read()
            assert hb is not None and hb.step == 3
            assert hb.interval_s > 0.0       # post-build runs measure
            # the beat carries the build's predicted step time
            pred = next(iter(exe._cache.values())).predicted
            assert hb.predicted_step_s == pytest.approx(
                pred["predicted_step_s"])
        finally:
            obs_hook.set_heartbeat(None)
            exe.close()
    finally:
        tpaddle.disable_static()
        tpaddle.static.reset_default_programs()


# -- the supervisor ----------------------------------------------------------
def test_supervisor_restarts_until_clean_exit(tmp_path):
    from paddle_tpu_torch.distributed.supervisor import TrainingSupervisor
    from paddle_tpu_torch.testing.chaos import _sv_flaky_entry
    sv = TrainingSupervisor(
        _sv_flaky_entry, args=(str(tmp_path / "state"), 2, 5),
        backoff_s=0.05, backoff_max_s=0.2, crash_budget=5,
        workdir=str(tmp_path))
    res = sv.run()
    assert res.clean_exit and res.attempts == 3 and res.restarts == 2
    assert [r["exit_code"] for r in res.exit_history] == [5, 5]
    assert all(r["reason"] == "crash(exit=5)" for r in res.exit_history)
    assert tmonitor.get_stat("supervisor.starts") == 3
    assert tmonitor.get_stat("supervisor.restarts") == 2
    assert tmonitor.get_stat("supervisor.clean_exits") == 1


def test_supervisor_crash_loop_gives_up_with_history(tmp_path):
    from paddle_tpu_torch.distributed.supervisor import (SupervisorGaveUp,
                                                         TrainingSupervisor)
    from paddle_tpu_torch.testing.chaos import _sv_flaky_entry
    sv = TrainingSupervisor(
        _sv_flaky_entry, args=(str(tmp_path / "state"), 10 ** 9, 3),
        backoff_s=0.01, crash_window_s=600.0, crash_budget=1,
        workdir=str(tmp_path))
    with pytest.raises(SupervisorGaveUp, match="giving up") as ei:
        sv.run()
    assert len(ei.value.exit_history) == 2
    assert all(r["exit_code"] == 3 for r in ei.value.exit_history)
    assert tmonitor.get_stat("supervisor.gave_up") == 1
    box = json.load(open(str(tmp_path / "supervisor_giveup.json")))
    assert box["reason"] == "supervisor.give_up"
    extra = box["extra"]
    assert extra["attempts"] == 2 and extra["crash_budget"] == 1
    assert [r["exit_code"] for r in extra["exit_history"]] == [3, 3]
    assert isinstance(extra["child_dumps"], list)
    assert "last_heartbeat" in extra and box.get("stats") is not None


def test_supervisor_watchdog_kills_hang_and_dumps_flight(tmp_path):
    from paddle_tpu_torch.distributed.supervisor import (StepWatchdog,
                                                         TrainingSupervisor)
    from paddle_tpu_torch.testing.chaos import _sv_hang_entry
    sv = TrainingSupervisor(
        _sv_hang_entry, args=(str(tmp_path / "state"),),
        watchdog=StepWatchdog(multiplier=6.0, min_deadline_s=1.0,
                              max_deadline_s=8.0),
        hang_grace_s=0.5, poll_s=0.1, backoff_s=0.05, crash_budget=5,
        workdir=str(tmp_path))
    res = sv.run()
    assert res.clean_exit and res.hang_kills == 1 and res.restarts == 1
    assert res.exit_history[0]["reason"] == "hang"
    assert tmonitor.get_stat("supervisor.hang_kills") == 1
    box = json.load(open(str(tmp_path / "supervisor_kill_a0.json")))
    assert box["reason"] == "supervisor.hang"
    assert box["extra"]["restart_reason"] == "hang"
    assert box["extra"]["attempt"] == 0
    assert box["extra"]["last_step"] is not None


def test_supervisor_restart_recompile_not_judged_at_step_scale(tmp_path):
    """A restarted child builds from scratch: until it produces a step
    beat only ``startup_timeout_s`` applies, so its quiet 3.5 s start is
    not judged by the 1.5 s deadline the previous incarnation's
    step-scale window gives."""
    from paddle_tpu_torch.distributed.supervisor import (StepWatchdog,
                                                         TrainingSupervisor)
    from paddle_tpu_torch.testing.chaos import _sv_slow_start_entry
    wd = StepWatchdog(multiplier=2.0, min_deadline_s=1.5, max_deadline_s=5.0)
    sv = TrainingSupervisor(
        _sv_slow_start_entry, args=(str(tmp_path / "state"), 3.5),
        watchdog=wd, startup_timeout_s=120.0, hang_grace_s=0.5,
        poll_s=0.05, backoff_s=0.05, crash_budget=5, workdir=str(tmp_path))
    res = sv.run()
    assert res.clean_exit and res.hang_kills == 0
    assert [r["exit_code"] for r in res.exit_history] == [3]
    assert tmonitor.get_stat("supervisor.hang_kills") == 0


def test_chaos_supervise_scenario_in_process(tmp_path):
    """``testing.chaos.supervise_main`` at world size 1: an injected NaN
    step skipped as a bitwise no-op, a hang watchdog-killed and a crash
    restarted, each resuming from a step snapshot, and the loss
    trajectory equal to the uninterrupted run's bit for bit."""
    from paddle_tpu_torch.testing import chaos
    res = {}
    assert chaos.supervise_main(workdir=str(tmp_path), result=res) == 0
    assert res["losses_equal"] and len(res["flagged_runs"]) == 1
    assert [r["reason"] for r in res["exit_history"]] == ["hang",
                                                          "crash(exit=7)"]


def test_chaos_supervise_rank_count_restart(tmp_path):
    """The drill's rank-count leg (paddle_tpu's 8 -> 4 devices): the
    first incarnation trains on 2 gloo ranks and crashes, the restart
    trains on 1 rank from the 2-rank snapshot (the reshardable
    ``SnapshotStore``), and the losses equal the uninterrupted run's
    within rtol 1e-5."""
    from paddle_tpu_torch.testing import chaos
    res = {}
    assert chaos.supervise_reshard_main(workdir=str(tmp_path),
                                        result=res) == 0
    assert [r["ranks"] for r in res["resumes"]] == [2, 1]
    assert res["resumes"][1]["step"] > 0


def _serving_verdicts(sv_mod):
    """A ``ServingSupervisor``'s liveness verdicts over a scripted run of
    probes and beats (no process): quiet but answering is never a hang;
    failed probes with stale beats past the budget are."""
    probes = iter([(True, False), (True, True), (True, True),
                   (False, False), (False, False), (False, False),
                   (False, False)])

    class Scripted(sv_mod.ServingSupervisor):
        def _probe(self):
            return next(probes)

    sv = Scripted(lambda: None, health_url="http://127.0.0.1:1/healthz",
                  ready_poll_s=0.0, ready_fail_budget=2,
                  hang_deadline_s=30.0, startup_timeout_s=60.0)
    sv._attempt_reset()
    old = sv_mod.Heartbeat(time.time() - 100.0, 5, None, 0.0)
    fresh = sv_mod.Heartbeat(time.time(), 6, None, 0.0)
    started = time.monotonic()
    out = []
    for hb in (None, None, old, old, old, fresh, old):
        out.append((sv._check_liveness(hb, hb is not None, started),
                    sv.ready))
    return out


def test_serving_supervisor_liveness_policy():
    from paddle_tpu.distributed import supervisor as jsv
    from paddle_tpu_torch.distributed import supervisor as tsv
    got = _serving_verdicts(tsv)
    assert got == _serving_verdicts(jsv)
    # warming up (reachable, not ready), ready, ready with an old beat,
    # then probes fail: within the budget, a fresh beat, past it: hang
    assert [v for v, _ in got] == [None, None, None, None, None, None,
                                   "hang"]
    assert [r for _, r in got] == [False, True, True, False, False,
                                   False, False]
    assert tmonitor.get_stat("supervisor.serving.ready_transitions") == 2
