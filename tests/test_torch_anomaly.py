"""The anomaly sentry, its fault actions and its policy held to
paddle_tpu (the twins of ``tests/test_anomaly.py``).

Single-process cases run each side on the same seeded numpy inputs:

- the ``corrupt`` action: spec round trip, the host modes and their hit
  accounting, the in-step window and its host mirror, the seeded
  ``p=0.4`` draw (each side's step and mirror agree; the draws differ
  between the packages: paddle_tpu keys ``jax.random``, the port a
  seeded ``random.Random``);
- the sentry on the plain path: a NaN feed's run is a bitwise no-op on
  parameters, slots and the update counter on both sides, with the
  fused Adam kernel's plain version and with the unfused update, and
  the clean runs' losses and parameters agree at rtol 1e-5; flipping
  ``FLAGS_anomaly_sentry`` rebuilds once, attributed ``new_sentry``;
- the policy ladder, give-up without a snapshot, deferred blame, the
  spike detector and the store check: the same decisions and stats;
- the supervisor's give-up flight dump (spawned children).

The multi-rank cases share one module-scoped world of 4 gloo CPU ranks
(``testing.anomaly_cases``, spawned once with a timeout, so a rank that
misses the flag's collective fails the module instead of hanging it):
one rank's NaN skipped by all, the int8 error-feedback oracle, the
hybrid {dp: 2, mp: 2} mesh, residuals riding a rollback, a corrupted
wire scale and poisoned gradients on the overlapped path.  Each no-op is bitwise; the clean runs are held to
paddle_tpu's Executor on the same mesh shape (first 4 of conftest's 8
devices): losses and parameters within 5e-5, the int8 tolerance of
``test_torch_grad_comm.py`` (a gradient's rounding can move an int8
level between the packages).
"""
import json

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import distributed as jdist, optimizer as joptimizer
from paddle_tpu.testing import fault as jfault
from paddle_tpu.utils import monitor as jmonitor

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.testing import anomaly_cases
from paddle_tpu_torch.testing import fault as tfault
from paddle_tpu_torch.utils import monitor as tmonitor

WORLD = 4
SPAWN_TIMEOUT_S = 300
SIDES = {"jax": (jfault, jmonitor), "torch": (tfault, tmonitor)}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jfault.disarm()
    tfault.disarm()


@pytest.fixture
def cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)


# ------------------------------------------------------ corrupt action --
@pytest.mark.parametrize("side", sorted(SIDES))
def test_corrupt_spec_parse_and_roundtrip(side):
    fault, _ = SIDES[side]
    spec = ("dataloader.batch:action=corrupt,mode=nan,count=1,after=2;"
            "grad_comm.wire:action=corrupt,mode=inf,n=3,tensor=*scales*;"
            "executor.grads:action=corrupt,mode=bitflip,p=0.5")
    rules = fault.parse_spec(spec)
    assert [r.mode for r in rules] == ["nan", "inf", "bitflip"]
    assert rules[1].n == 3 and rules[1].tensor == "*scales*"
    again = fault.parse_spec(";".join(r.to_spec() for r in rules))
    assert [r.to_spec() for r in again] == [r.to_spec() for r in rules]
    with pytest.raises(ValueError, match="corrupt mode"):
        fault.parse_spec("x:action=corrupt,mode=zero")
    # both packages write the same spec strings
    assert [r.to_spec() for r in rules] == [
        r.to_spec() for r in SIDES["jax"][0].parse_spec(spec)]


def _host_modes(fault, wrap):
    out = []
    fault.arm("p:action=corrupt,mode=nan,count=1,after=1")
    src = np.ones(4, np.float32)
    out.append(np.asarray(fault.corrupt_host("p", wrap(src))))
    out.append(np.asarray(fault.corrupt_host("p", wrap(src))))
    out.append(np.asarray(fault.corrupt_host("p", wrap(src))))
    assert not np.isnan(src).any()          # the original never changes
    out.append(fault.fire_count("p"))
    fault.arm("p:action=corrupt,mode=inf,n=2,match=batch=3")
    tree = {"x": np.zeros(4, np.float32), "y": (np.zeros(2, np.float32),)}
    clean = fault.corrupt_host("p", tree, "batch=1")
    bad = fault.corrupt_host("p", tree, "batch=3")
    out += [clean["x"], bad["x"], bad["y"][0]]
    fault.arm("p:action=corrupt,mode=nan")
    out.append(np.asarray(fault.corrupt_host(
        "p", wrap(np.arange(4, dtype=np.int64)))))
    fault.arm("p:action=corrupt,mode=bitflip,n=2")
    out.append(np.asarray(fault.corrupt_host(
        "p", wrap(np.full(3, 1.5, np.float32)))))
    return out


def test_corrupt_host_modes_and_accounting():
    """The same hits, windows and poisons on both sides; the port's also
    on a tensor leaf."""
    j = _host_modes(jfault, lambda a: a)
    t = _host_modes(tfault, lambda a: a)
    tt = _host_modes(tfault, torch.from_numpy)
    assert not np.isnan(j[0]).any() and np.isnan(j[1][0])
    assert not np.isnan(j[1][1:]).any() and not np.isnan(j[2]).any()
    assert j[3] == 1 and j[7][0] != 0 and list(j[7][1:]) == [1, 2, 3]
    assert np.isinf(j[5][:2]).all() and np.isinf(j[6]).all()
    assert not np.isinf(j[4]).any()
    for a, b, c in zip(j, t, tt):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_corrupt_in_graph_window_and_host_mirror():
    fired = {}
    for side, (fault, monitor) in SIDES.items():
        fault.arm("g:action=corrupt,mode=inf,count=2,after=1,n=2")
        if side == "jax":
            import jax.numpy as jnp
            f = jax.jit(lambda s, x: fault.corrupt_in_graph(
                "g", x, s, tensor="w"))
            got = [np.asarray(f(jnp.asarray(s, jnp.int32), jnp.ones(4)))
                   for s in range(1, 5)]
        else:
            got = [fault.corrupt_in_graph("g", torch.ones(4), s,
                                          tensor="w").numpy()
                   for s in range(1, 5)]
        fired[side] = [bool(np.isinf(a).any()) for a in got]
        sites = fault.graph_corrupt_sites([("g", "w"), ("g", "other")])
        assert len(sites) == 2                   # no tensor glob: both
        n0 = monitor.get_stat("fault.fired.g")
        for s in range(1, 5):
            fault.mirror_graph_fires(sites[:1], s)
        assert monitor.get_stat("fault.fired.g") - n0 == 2
    assert fired["jax"] == fired["torch"] == [False, True, True, False]


def test_corrupt_in_graph_probability_matches_mirror():
    for side, (fault, _) in SIDES.items():
        fault.arm("pp:action=corrupt,mode=nan,p=0.4", seed=11)
        if side == "jax":
            import jax.numpy as jnp
            f = jax.jit(lambda s, x: fault.corrupt_in_graph("pp", x, s))
            graph = [bool(np.isnan(np.asarray(
                f(jnp.asarray(s, jnp.int32), jnp.ones(3)))).any())
                for s in range(1, 21)]
        else:
            graph = [bool(torch.isnan(fault.corrupt_in_graph(
                "pp", torch.ones(3), s)).any()) for s in range(1, 21)]
        sites = fault.graph_corrupt_sites([("pp", "")])
        host = []
        for s in range(1, 21):
            before = fault.fire_count("pp")
            fault.mirror_graph_fires(sites, s)
            host.append(fault.fire_count("pp") > before)
        assert graph == host and any(graph) and not all(graph)
        # the draw replays: a fresh arm with the same seed
        fault.arm("pp:action=corrupt,mode=nan,p=0.4", seed=11)
        sites = fault.graph_corrupt_sites([("pp", "")])
        again = []
        for s in range(1, 21):
            before = fault.fire_count("pp")
            fault.mirror_graph_fires(sites, s)
            again.append(fault.fire_count("pp") > before)
        assert again == host


# ------------------------------------------------- sentry: plain path --
def _plain_program(pkg, F, opt_mod, lr=0.1):
    pkg.seed(7)
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [None, 4], "float32")
        y = pkg.static.data("y", [None, 1], "float32")
        loss = F.mse_loss(pkg.static.nn.fc(x, 1), y)
        opt_mod.Adam(learning_rate=lr).minimize(loss)
    return main, loss


def _feeds():
    rng = np.random.RandomState(0)
    xs = rng.standard_normal((8, 4)).astype(np.float32)
    ys = rng.standard_normal((8, 1)).astype(np.float32)
    xbad = xs.copy()
    xbad[0, 0] = np.nan
    return xs, ys, xbad


def _jax_plain(init, tier):
    # the fused Adam on paddle_tpu's side: its Pallas kernel in
    # interpret mode (the same bias-correction form as the port's)
    jpaddle.set_flags({"anomaly_sentry": True, "pallas_interpret": tier})
    jpaddle.enable_static()
    try:
        main, loss = _plain_program(jpaddle, JF, joptimizer)
        for p, a in zip(main.parameters(), init):
            p.data = jax.numpy.asarray(a)
        exe = jpaddle.static.Executor()
        xs, ys, xbad = _feeds()
        losses = [float(exe.run(main, feed={"x": xs, "y": ys},
                                fetch_list=[loss])[0])]
        state = exe._states[main._serial]
        p0 = [np.asarray(a) for a in state.p_arrays]
        s0 = [{k: np.asarray(v) for k, v in s.items()}
              for s in state.opt_state]
        step0 = int(np.asarray(state.aux["step"]))
        bad = exe.run(main, feed={"x": xbad, "y": ys}, fetch_list=[loss])[0]
        noop = (all(np.array_equal(a, np.asarray(b))
                    for a, b in zip(p0, state.p_arrays))
                and all(np.array_equal(b[k], np.asarray(a[k]))
                        for b, a in zip(s0, state.opt_state) for k in b)
                and int(np.asarray(state.aux["step"])) == step0)
        st = exe.sentry_stats(main)
        losses.append(float(exe.run(main, feed={"x": xs, "y": ys},
                                    fetch_list=[loss])[0]))
        params = [np.asarray(a) for a in state.p_arrays]
        return dict(bad=float(bad), noop=noop, stats=st, losses=losses,
                    params=params, compiles=exe.compile_count)
    finally:
        jpaddle.set_flags({"anomaly_sentry": False,
                           "pallas_interpret": False})
        jpaddle.disable_static()
        jpaddle.static.reset_default_programs()


def _torch_plain(init, tier):
    tpaddle.set_flags({"anomaly_sentry": True, "use_pallas_kernels": tier})
    tpaddle.enable_static()
    try:
        main, loss = _plain_program(tpaddle, TF, toptimizer)
        with torch.no_grad():
            for p, a in zip(main.parameters(), init):
                p.copy_(torch.from_numpy(a))
        exe = tpaddle.static.Executor()
        xs, ys, xbad = _feeds()
        losses = [float(exe.run(main, feed={"x": xs, "y": ys},
                                fetch_list=[loss])[0])]
        state = exe._states[main._serial]
        p0 = [p.detach().clone() for p in main.parameters()]
        s0 = {k: {n: t.clone() for n, t in v.items()}
              for k, v in state.slots.items()}
        step0 = state.step.clone()
        bad = exe.run(main, feed={"x": xbad, "y": ys}, fetch_list=[loss])[0]
        noop = (all(torch.equal(a, b) for a, b in
                    zip(p0, main.parameters()))
                and all(torch.equal(t, state.slots[k][n])
                        for k, v in s0.items() for n, t in v.items())
                and torch.equal(step0, state.step))
        st = exe.sentry_stats(main)
        losses.append(float(exe.run(main, feed={"x": xs, "y": ys},
                                    fetch_list=[loss])[0]))
        params = [p.detach().numpy().copy() for p in main.parameters()]
        kernels = next(iter(exe._cache.values())).kernels
        return dict(bad=float(bad), noop=noop, stats=st, losses=losses,
                    params=params, compiles=exe.compile_count,
                    kernels=kernels)
    finally:
        tpaddle.set_flags({"anomaly_sentry": False,
                           "use_pallas_kernels": True})
        tpaddle.disable_static()
        tpaddle.static.reset_default_programs()


@pytest.mark.parametrize("tier", [True, False], ids=["fused", "unfused"])
def test_sentry_skip_is_bitwise_noop_plain(cpu, tier):
    """A NaN feed: the fetch shows the NaN, every piece of carried state
    is bitwise untouched, one skip counted, one build; the clean runs
    agree with paddle_tpu.  ``fused``: the fused Adam kernel's plain
    version takes the flag; ``unfused``: the optimizer's update and a
    select."""
    rng = np.random.RandomState(3)
    init = [rng.standard_normal((4, 1)).astype(np.float32),
            rng.standard_normal((1,)).astype(np.float32)]
    j = _jax_plain(init, tier)
    t = _torch_plain(init, tier)
    for side in (j, t):
        assert np.isnan(side["bad"]) and side["noop"]
        assert side["stats"]["skipped_steps"] == 1
        assert side["stats"]["last_flag"] == 1
        assert side["compiles"] == 1
    assert t["stats"]["last_nonfinite"] == j["stats"]["last_nonfinite"]
    assert ("fused_adam" in t["kernels"]) == tier
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)
    # two Adam steps at lr 0.1 move a parameter by up to 0.2; the two
    # packages' updates round in another order (the unfused one takes
    # lr / bc1 first), so parameters agree within 1e-5 of that move
    for a, b in zip(t["params"], j["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6)


def test_sentry_flip_recompiles_with_attribution(cpu):
    from paddle_tpu_torch.observability import explain_compiles
    tpaddle.enable_static()
    try:
        main, loss = _plain_program(tpaddle, TF, toptimizer)
        exe = tpaddle.static.Executor()
        xs, ys, _ = _feeds()
        feed = {"x": xs, "y": ys}
        exe.run(main, feed=feed, fetch_list=[loss])
        tpaddle.set_flags({"anomaly_sentry": True})
        try:
            exe.run(main, feed=feed, fetch_list=[loss])
        finally:
            tpaddle.set_flags({"anomaly_sentry": False})
        exe.run(main, feed=feed, fetch_list=[loss])
        assert exe.compile_count == 2          # flip back = cache hit
        rec = [r for r in explain_compiles("executor")["records"]
               if r["cause"] == "new_sentry"]
        assert rec, "sentry flip not attributed"
    finally:
        tpaddle.disable_static()
        tpaddle.static.reset_default_programs()


def test_sentry_grads_corruption_point_and_mirror(cpu):
    """``executor.grads`` poisons a gradient in the step at its run
    window; the sentry skips that run; the mirror counts a fire for each
    gradient the rule matched (the weight's and the bias's)."""
    tpaddle.set_flags({"anomaly_sentry": True})
    tfault.arm("executor.grads:action=corrupt,mode=inf,count=1,after=1")
    tpaddle.enable_static()
    try:
        main, loss = _plain_program(tpaddle, TF, toptimizer)
        exe = tpaddle.static.Executor()
        xs, ys, _ = _feeds()
        for _ in range(3):
            exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        st = exe.sentry_stats(main)
        assert st["skipped_steps"] == 1 and st["last_flag"] == 0
        assert tfault.fire_count("executor.grads") == 2
    finally:
        tpaddle.set_flags({"anomaly_sentry": False})
        tpaddle.disable_static()
        tpaddle.static.reset_default_programs()


# ------------------------------------------------------ policy ladder --
def _vals(flag, nf=0, extra=0, norm2=1.0):
    return (np.asarray(flag, np.int32), np.asarray([nf], np.int32),
            np.asarray(extra, np.int32), np.asarray(norm2, np.float32))


class _StateObj:
    def __init__(self, v):
        self.v = dict(v)

    def state_dict(self):
        return dict(self.v)

    def set_state_dict(self, d):
        self.v = dict(d)


def _policy_mods(side):
    if side == "jax":
        from paddle_tpu.distributed import AnomalyEscalation, AnomalyPolicy
        from paddle_tpu.utils.checkpoint import SnapshotStore
        return AnomalyPolicy, AnomalyEscalation, SnapshotStore, jmonitor
    from paddle_tpu_torch.distributed import AnomalyEscalation, AnomalyPolicy
    from paddle_tpu_torch.utils.checkpoint import SnapshotStore
    return AnomalyPolicy, AnomalyEscalation, SnapshotStore, tmonitor


def _ladder(side, d, as_tensor):
    AnomalyPolicy, AnomalyEscalation, SnapshotStore, monitor = \
        _policy_mods(side)
    monitor.stat_reset()
    store = SnapshotStore(str(d / side / "ckpt"))
    obj = _StateObj({"w": np.ones(2, np.float32)})
    store.save(0, {"train": obj}, step=4, kind="step")
    obj.v["w"] = np.zeros(2, np.float32)
    policy = AnomalyPolicy(store=store, objects={"train": obj},
                           skip_budget=2, rollback_budget=1)
    policy.note_batch(9)
    step = [0]
    conv = (lambda v: tuple(torch.from_numpy(np.asarray(a)) for a in v)) \
        if as_tensor else (lambda v: v)

    def feed(flag, **kw):
        step[0] += 1
        policy.on_step(None, None, step[0], conv(_vals(flag, **kw)),
                       ("loss",), (np.asarray(0.5),))
        return policy.poll()

    seq = [feed(0), feed(1, nf=3), feed(1, nf=3), feed(1, nf=3)]
    ledger0 = policy.ledger[0]["batch"]
    seq.append(feed(1, nf=1))
    restored = (policy.resume_step, np.asarray(obj.v["w"]).tolist(),
                policy.data_seed)
    seq += [feed(0), feed(1, nf=1), feed(1, nf=1), feed(1, nf=1)]
    with pytest.raises(AnomalyEscalation) as ei:
        feed(1, nf=1)
    stats = {k: v for k, v in monitor.all_stats().items()
             if k.startswith("anomaly.")}
    return seq, ledger0, restored, len(ei.value.ledger), stats


def test_policy_ladder_skip_quarantine_rollback_giveup(cpu, tmp_path):
    j = _ladder("jax", tmp_path, False)
    t = _ladder("torch", tmp_path, True)      # the sentry's tensors
    assert t == j
    assert j[0] == ["ok", "skip", "skip", "quarantine", "rollback", "ok",
                    "skip", "skip", "quarantine"]
    assert j[1] == 9 and j[2] == (4, [1.0, 1.0], 1) and j[3] == 2
    assert j[4]["anomaly.skips"] == 4 and j[4]["anomaly.giveups"] == 1


@pytest.mark.parametrize("side", sorted(SIDES))
def test_policy_rollback_without_snapshot_gives_up(cpu, side, tmp_path):
    AnomalyPolicy, AnomalyEscalation, SnapshotStore, _ = _policy_mods(side)
    store = SnapshotStore(str(tmp_path / "empty"))
    obj = _StateObj({"w": np.ones(1, np.float32)})
    policy = AnomalyPolicy(store=store, objects={"train": obj},
                           skip_budget=0, rollback_budget=1)
    policy.on_step(None, None, 1, _vals(1, nf=1), (), ())
    assert policy.poll() == "quarantine"
    with pytest.raises(AnomalyEscalation, match="no published snapshot"):
        policy.on_step(None, None, 2, _vals(1, nf=1), (), ())
    assert policy.rollbacks == 0


@pytest.mark.parametrize("side", sorted(SIDES))
def test_policy_deferred_mode_blames_the_step_that_ran(side):
    AnomalyPolicy = _policy_mods(side)[0]
    policy = AnomalyPolicy(skip_budget=0, sync=False)
    policy.note_batch("poisoned")
    policy.on_step(None, None, 1, _vals(1, nf=1), (), ())
    policy.note_batch("healthy")
    policy.on_step(None, None, 2, _vals(0), (), ())
    assert policy.poll() == "quarantine"
    assert policy.ledger[0]["batch"] == "poisoned"


def test_policy_loss_spike_detector():
    out = {}
    for side in SIDES:
        AnomalyPolicy, _, _, monitor = _policy_mods(side)
        monitor.stat_reset()
        policy = AnomalyPolicy(skip_budget=5, spike_window=8,
                               spike_factor=10.0)
        polls = []
        for s in range(6):
            policy.on_step(None, None, s + 1, _vals(0), ("loss",),
                           (np.asarray(1.0 + 0.01 * s),))
            polls.append(policy.poll())
        loss = (torch.tensor(1e6) if side == "torch" else np.asarray(1e6))
        policy.on_step(None, None, 7, _vals(0), ("loss",), (loss,))
        polls.append(policy.poll())
        out[side] = (polls, monitor.get_stat("anomaly.loss_spikes"),
                     policy.loss_spikes,
                     monitor.get_stat("anomaly.grad_norm"))
    assert out["torch"] == out["jax"]
    assert out["jax"][0] == ["ok"] * 6 + ["skip"] and out["jax"][1] == 1


@pytest.mark.parametrize("side", sorted(SIDES))
def test_policy_requires_store_with_objects(side):
    with pytest.raises(ValueError, match="store AND objects"):
        _policy_mods(side)[0](store=object())


# --------------------------------------------- supervisor black box --
def test_supervisor_giveup_leaves_flight_dump(tmp_path):
    from paddle_tpu_torch.distributed.supervisor import (SupervisorGaveUp,
                                                         TrainingSupervisor)
    from paddle_tpu_torch.testing.chaos import _sv_flaky_entry
    sv = TrainingSupervisor(
        _sv_flaky_entry, args=(str(tmp_path / "n"), 99, 5), name="doomed",
        startup_timeout_s=60.0, poll_s=0.05, backoff_s=0.01,
        backoff_max_s=0.02, crash_window_s=60.0, crash_budget=1,
        max_restarts=3, workdir=str(tmp_path))
    with pytest.raises(SupervisorGaveUp) as ei:
        sv.run()
    box = json.loads((tmp_path / "supervisor_giveup.json").read_text())
    assert box["reason"] == "supervisor.give_up"
    extra = box["extra"]
    assert extra["supervisor"] == "doomed"
    assert extra["exit_history"] == ei.value.exit_history
    assert all(r["exit_code"] == 5 for r in extra["exit_history"])


# ------------------------------------------- the 4-rank gloo world --
def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jdist.init_mesh(dict(shape), devices=jax.devices()[:n])


def _jax_program(shape, mp_cut=False):
    _jmesh(shape)
    jpaddle.seed(7)
    main = jpaddle.static.Program()
    with jpaddle.static.program_guard(main):
        x = jpaddle.static.data("x", [None, 8], "float32")
        y = jpaddle.static.data("y", [None, 1], "float32")
        h = jpaddle.static.nn.fc(x, 8)
        loss = JF.mse_loss(jpaddle.static.nn.fc(JF.relu(h), 1), y)
        strat = jdist.DistributedStrategy()
        strat.grad_comm = dict(anomaly_cases.GC)
        f = jdist.fleet
        f.init(is_collective=True, strategy=strat)
        f.distributed_optimizer(joptimizer.Adam(
            learning_rate=0.05)).minimize(loss)
    _jmesh(shape)
    if mp_cut:
        wname = next(p.name for p in main.parameters()
                     if p.data.shape == (8, 8))
        main._sharding_rules = [(wname, (None, "mp")), (r".*", ())]
    return main, loss


def _jax_sequence(shape, batches, mp_cut=False):
    main, loss = _jax_program(shape, mp_cut)
    init = [np.asarray(p.data) for p in main.parameters()]
    exe = jpaddle.static.Executor()
    losses = [float(exe.run(main, feed={"x": xs, "y": ys},
                            fetch_list=[loss])[0]) for xs, ys in batches]
    state = exe._states[main._serial]
    out = dict(params=[np.asarray(a) for a in state.p_arrays],
               res=[np.asarray(a) for a in state.aux["grad_comm"]],
               step=int(np.asarray(state.aux["step"])),
               skipped=exe.sentry_stats(main)["skipped_steps"],
               losses=losses, init=init)
    exe.close()
    jpaddle.static.reset_default_programs()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """paddle_tpu's references, then one spawn of 4 gloo ranks for
    every case of ``testing.anomaly_cases``."""
    out = tmp_path_factory.mktemp("anomaly_ranks")
    rng = np.random.RandomState(3)
    b1, b2 = anomaly_cases.int8_feed(rng), anomaly_cases.int8_feed(rng)
    mx, my = anomaly_cases.int8_feed(np.random.RandomState(1))
    rx, ry = anomaly_cases.int8_feed(np.random.RandomState(5))
    bad = (np.full_like(b1[0], np.nan), b1[1])
    jpaddle.set_flags({"anomaly_sentry": True})
    jpaddle.enable_static()
    try:
        ref = {"dp": _jax_sequence({"dp": 4}, [b1, b2]),
               "dp_bad": _jax_sequence({"dp": 4}, [b1, bad, b2]),
               "hybrid": _jax_sequence({"dp": 2, "mp": 2}, [b1, b2],
                                       mp_cut=True),
               "hybrid_bad": _jax_sequence({"dp": 2, "mp": 2},
                                           [b1, bad, b2], mp_cut=True),
               "mesh": _jax_sequence({"dp": 4}, [(mx, my)] * 2)}
    finally:
        jpaddle.set_flags({"anomaly_sentry": False})
        jpaddle.disable_static()
        jpaddle.static.reset_default_programs()
    data = {f"p{i}": a for i, a in enumerate(ref["dp"]["init"])}
    data.update(b1x=b1[0], b1y=b1[1], b2x=b2[0], b2y=b2[1], mx=mx, my=my,
                rx=rx, ry=ry)
    np.savez(out / "inputs.npz", **data)
    spawn(anomaly_cases.run, (str(out), list(anomaly_cases.CASES)),
          nprocs=WORLD, init_method=f"file://{out}/store",
          timeout=SPAWN_TIMEOUT_S)
    res = [dict(np.load(out / f"rank{i}.npz")) for i in range(WORLD)]
    return ref, res


def _n(res, case, tag, kind="p"):
    keys = sorted((k for k in res if k.startswith(f"{case}/{tag}.{kind}")
                   and k[len(f"{case}/{tag}.{kind}"):].isdigit()),
                  key=lambda k: int(k.rsplit(kind, 1)[1]))
    return [res[k] for k in keys]


def test_sentry_mesh_agreement_one_shard_nan(world):
    """One rank's slice carries the NaN: the summed flag makes every
    rank skip; params, residuals and the update counter stay bitwise;
    every rank holds the same params; one build; the clean runs' losses
    match paddle_tpu's."""
    ref, res = world
    for r in res:
        assert int(r["mesh_nan/skipped"]) == 1
        assert int(r["mesh_nan/last_flag"]) == 1
        assert int(r["mesh_nan/compiles"]) == 1
        assert int(r["mesh_nan/step_after"]) == int(
            r["mesh_nan/step_before"]) == 2
        for kind in ("p", "r"):
            for a, b in zip(_n(r, "mesh_nan", "before", kind),
                            _n(r, "mesh_nan", "after", kind)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(_n(r, "mesh_nan", "after"),
                        _n(res[0], "mesh_nan", "after")):
            np.testing.assert_array_equal(a, b)
        assert np.isnan(float(r["mesh_nan/bad_loss"]))
    np.testing.assert_allclose(res[0]["mesh_nan/losses"],
                               ref["mesh"]["losses"], rtol=0, atol=5e-5)


@pytest.mark.parametrize("case,tag", [("ef_oracle", "dp"),
                                      ("hybrid", "hybrid")])
def test_sentry_int8_ef_skip_oracle(world, case, tag):
    """(b1, bad, b2) ends bitwise where (b1, b2) does: params and the
    error-feedback residuals, on {dp: 4} and on the hybrid {dp: 2, mp:
    2} mesh; one skip, two updates; paddle_tpu counts the same, and the
    clean sequence's losses and params agree with its."""
    ref, res = world
    for r in res:
        assert int(r[f"{case}/ref.skipped"]) == 0
        assert int(r[f"{case}/got.skipped"]) == 1
        assert int(r[f"{case}/ref.step"]) == int(r[f"{case}/got.step"]) == 2
        for kind in ("p", "r"):
            got, want = _n(r, case, "got", kind), _n(r, case, "ref", kind)
            assert len(got) == len(want) and got
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    j, jb = ref[tag], ref[f"{tag}_bad"]
    assert (j["skipped"], jb["skipped"], j["step"], jb["step"]) == (0, 1, 2,
                                                                    2)
    np.testing.assert_allclose(res[0][f"{case}/ref.losses"], j["losses"],
                               rtol=0, atol=5e-5)
    for a, b in zip(_n(res[0], case, "ref"), j["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-5)


def test_ef_residuals_ride_snapshot_rollback(world):
    _, res = world
    for r in res:
        assert int(r["rollback/moved"]) == 1
        assert int(r["rollback/restored"]) == 1
        assert int(r["rollback/step"]) == 3


def test_sentry_grads_corruption_on_the_overlapped_path(world):
    """``executor.grads`` on the overlapped ('xla') path: the poisoned
    gradients reach the buckets issued during backward, every rank
    skips the run as a bitwise no-op, and the mirror counts one fire a
    gradient."""
    _, res = world
    for r in res:
        assert str(r["grads/overlap"]) == "xla"
        assert int(r["grads/skipped"]) == 1 and int(r["grads/noop"]) == 1
        assert int(r["grads/fires"]) == int(r["grads/params"]) == 4


def test_sentry_wire_scale_corruption_skipped_by_all(world):
    """A NaN int8 block scale on the wire (every rank's payload, run 3):
    the wire guard catches it, every rank skips that run as a bitwise
    no-op, the mirror counts one fire a rank, the next run is clean."""
    _, res = world
    for r in res:
        assert int(r["wire/skipped"]) == 1 and int(r["wire/noop"]) == 1
        assert int(r["wire/fires"]) == 1
        assert int(np.asarray(r["wire/post"]).sum()) > 0
        assert int(r["wire/skipped_after"]) == 1


def test_chaos_anomaly_drill_on_four_ranks(world):
    """``chaos.anomaly_main``'s drill (``tests/test_anomaly.py``'s
    ``test_chaos_anomaly_scenario_in_process``, there on 8 virtual
    devices): under NaN feeds, an inf gradient bucket, a NaN int8 wire
    scale and a poisoned-feed burst, every rank skips 5 runs, blames
    batch 9 once, rolls back to the step-8 snapshot and ends with the
    fault-free run's losses (rtol 1e-5) and parameters; the sentry's
    counter keeps every flagged run (7) across the restore, as
    paddle_tpu's does."""
    from paddle_tpu_torch.testing import chaos
    _, res = world
    for r in res:
        got = {k.split("/", 1)[1]: r[k] for k in r if k.startswith("chaos/")}
        assert chaos.anomaly_problems(got) == []
        assert int(got["sentry_skipped"]) == 7
