"""Rank code of the anomaly sentry's multi-rank tests: each case runs on
every rank of one ``torch.distributed`` job (``run`` is the entry
``distributed.launch.spawn`` starts) and returns what this rank saw.
It imports torch and the port only.

The program is ``tests/test_anomaly.py``'s ``_int8_program``: fc(8) ->
relu -> fc(1), mse, Adam(0.05) through ``fleet.distributed_optimizer``
with an int8 error-feedback ``grad_comm`` (block 64, scatter threshold
0.01 KB), its initial parameters taken from the inputs (``p<i>``), so
the port and paddle_tpu start from the same weights.  Every case runs
with ``FLAGS_anomaly_sentry`` on:

- ``mesh_nan``: dp 4, two clean runs, then a run whose NaN row lies in
  one rank's slice of the batch: every rank skips, and the parameters,
  residuals and update counter stay bitwise as they were;
- ``ef_oracle``: the sequences (b1, b2) and (b1, bad, b2): the skipped
  run changes nothing, so both end bitwise equal;
- ``hybrid``: the same two sequences on {dp: 2, mp: 2} with the 8x8
  weight cut over 'mp';
- ``rollback``: three runs, a sharded snapshot, two more, a restore: the
  residuals and the update counter come back bitwise;
- ``wire``: an int8 block scale corrupted on the wire (NaN, one run, on
  every rank's payload): the wire guard flags the run and all ranks
  skip; the host mirror counts the fire;
- ``grads``: every gradient poisoned (inf) at one run on the
  overlapped path, where buckets are issued during backward;
- ``chaos``: ``chaos.anomaly_main``'s drill (NaN feeds, an inf gradient
  bucket, a NaN wire scale, a poisoned-feed burst) against the
  fault-free run, gated by ``chaos.anomaly_problems``.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

__all__ = ["run", "CASES", "int8_feed"]

GC = {"dtype": "int8", "error_feedback": True, "scatter_threshold_KB": 0.01,
      "block_size": 64}


def int8_feed(rng):
    """``tests/test_anomaly.py``'s ``_int8_feed``."""
    xs = rng.standard_normal((64, 8)).astype(np.float32)
    ys = (xs @ rng.standard_normal((8, 1))).astype(np.float32)
    return xs, ys


def _program(data, shape, mp_cut=False):
    """The int8 program on mesh ``shape``, its weights from ``data``."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from .. import distributed as dist, optimizer
    dist.init_mesh(dict(shape))
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [None, 8], "float32")
        y = paddle.static.data("y", [None, 1], "float32")
        h = paddle.static.nn.fc(x, 8)
        loss = F.mse_loss(paddle.static.nn.fc(F.relu(h), 1), y)
        strat = dist.DistributedStrategy()
        strat.grad_comm = dict(GC)
        dist.fleet.init(is_collective=True, strategy=strat)
        opt = dist.fleet.distributed_optimizer(
            optimizer.Adam(learning_rate=0.05))
        opt.minimize(loss)
    dist.init_mesh(dict(shape))
    with torch.no_grad():
        for i, p in enumerate(main.parameters()):
            p.copy_(torch.from_numpy(data[f"p{i}"]))
    if mp_cut:
        wname = next(p.name for p in main.parameters()
                     if tuple(p.shape) == (8, 8))
        main._sharding_rules = [(wname, (None, "mp")), (r".*", ())]
    return main, loss


def _state(exe, main):
    """(params, residuals, update counter) as numpy, full params."""
    exe.sync_params(main)
    st = exe._states[main._serial]
    return ([p.detach().cpu().numpy().copy() for p in main.parameters()],
            [r.detach().cpu().numpy().copy() for r in st.ef],
            int(st.step))


def _sequence(data, shape, batches, mp_cut=False):
    import paddle_tpu_torch as paddle
    main, loss = _program(data, shape, mp_cut)
    exe = paddle.static.Executor()
    losses = [float(exe.run(main, feed={"x": xs, "y": ys},
                            fetch_list=[loss])[0]) for xs, ys in batches]
    params, res, step = _state(exe, main)
    sen = exe.sentry_stats(main)
    exe.close()
    paddle.static.reset_default_programs()
    return params, res, step, sen, losses


def _pack(out, tag, params, res):
    for i, a in enumerate(params):
        out[f"{tag}.p{i}"] = a
    for i, a in enumerate(res):
        out[f"{tag}.r{i}"] = a


def _bad(data):
    return (np.full_like(data["b1x"], np.nan), data["b1y"])


def case_mesh_nan(data, device) -> Dict[str, object]:
    import paddle_tpu_torch as paddle
    main, loss = _program(data, {"dp": 4})
    exe = paddle.static.Executor()
    feed = {"x": data["mx"], "y": data["my"]}
    out = {"losses": [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                      for _ in range(2)]}
    p0, r0, s0 = _state(exe, main)
    xbad = data["mx"].copy()
    xbad[25, :] = np.nan            # rows 16..31: rank 1's slice
    out["bad_loss"] = float(exe.run(main, feed={"x": xbad, "y": data["my"]},
                                    fetch_list=[loss])[0])
    p1, r1, s1 = _state(exe, main)
    sen = exe.sentry_stats(main)
    _pack(out, "before", p0, r0)
    _pack(out, "after", p1, r1)
    out.update(step_before=s0, step_after=s1,
               skipped=sen["skipped_steps"], last_flag=sen["last_flag"],
               compiles=exe.compile_count)
    exe.close()
    paddle.static.reset_default_programs()
    return out


def _two_sequences(data, shape, mp_cut) -> Dict[str, object]:
    b1, b2 = (data["b1x"], data["b1y"]), (data["b2x"], data["b2y"])
    out = {}
    for tag, batches in (("ref", [b1, b2]), ("got", [b1, _bad(data), b2])):
        params, res, step, sen, losses = _sequence(data, shape, batches,
                                                   mp_cut)
        _pack(out, tag, params, res)
        out[f"{tag}.step"] = step
        out[f"{tag}.skipped"] = sen["skipped_steps"]
        out[f"{tag}.losses"] = losses
    return out


def case_ef_oracle(data, device) -> Dict[str, object]:
    return _two_sequences(data, {"dp": 4}, False)


def case_hybrid(data, device) -> Dict[str, object]:
    return _two_sequences(data, {"dp": 2, "mp": 2}, True)


def case_rollback(data, device) -> Dict[str, object]:
    import paddle_tpu_torch as paddle
    from ..utils.checkpoint import SnapshotStore
    main, loss = _program(data, {"dp": 4})
    exe = paddle.static.Executor()
    feed = {"x": data["rx"], "y": data["ry"]}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss])
    ss = exe.sharded_state(main)
    store = SnapshotStore(os.path.join(str(data["outdir"]), "ckpt"))
    store.save(0, {"train": ss}, step=3, kind="step")
    _, r_saved, _ = _state(exe, main)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss])
    _, r_moved, _ = _state(exe, main)
    store.restore({"train": ss})
    _, r_back, step = _state(exe, main)
    out = {"step": step,
           "moved": int(any(not np.array_equal(a, b)
                            for a, b in zip(r_saved, r_moved))),
           "restored": int(all(np.array_equal(a, b)
                               for a, b in zip(r_saved, r_back)))}
    exe.close()
    paddle.static.reset_default_programs()
    return out


def case_wire(data, device) -> Dict[str, object]:
    import paddle_tpu_torch as paddle
    from . import fault
    fault.arm("grad_comm.wire:action=corrupt,mode=nan,count=1,after=2,"
              "tensor=*scales*")
    try:
        main, loss = _program(data, {"dp": 4})
        exe = paddle.static.Executor()
        feed = {"x": data["mx"], "y": data["my"]}
        exe.run(main, feed=feed, fetch_list=[loss])
        exe.run(main, feed=feed, fetch_list=[loss])
        p0, r0, s0 = _state(exe, main)
        exe.run(main, feed=feed, fetch_list=[loss])      # run 3: corrupted
        p1, r1, s1 = _state(exe, main)
        sen = exe.sentry_stats(main)
        out = {"skipped": sen["skipped_steps"],
               "extra": sen["last_nonfinite_extra"],
               "post": np.asarray(sen["last_nonfinite"]),
               "noop": int(s0 == s1 and all(
                   np.array_equal(a, b) for a, b in zip(p0 + r0, p1 + r1))),
               "fires": fault.fire_count("grad_comm.wire")}
        exe.run(main, feed=feed, fetch_list=[loss])      # clean again
        out["skipped_after"] = exe.sentry_stats(main)["skipped_steps"]
        exe.close()
    finally:
        fault.disarm()
        paddle.static.reset_default_programs()
    return out


def case_grads(data, device) -> Dict[str, object]:
    """``executor.grads`` (inf, every gradient, run 3) on the overlapped
    path: the poison reaches the buckets issued during backward, every
    rank skips, the mirror counts a fire a gradient."""
    import paddle_tpu_torch as paddle
    from . import fault
    fault.arm("executor.grads:action=corrupt,mode=inf,count=1,after=2")
    try:
        main, loss = _program(data, {"dp": 4})
        exe = paddle.static.Executor()
        feed = {"x": data["mx"], "y": data["my"]}
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss])
        p0, r0, s0 = _state(exe, main)
        exe.run(main, feed=feed, fetch_list=[loss])
        p1, r1, s1 = _state(exe, main)
        out = {"skipped": exe.sentry_stats(main)["skipped_steps"],
               "noop": int(s0 == s1 and all(
                   np.array_equal(a, b) for a, b in zip(p0 + r0, p1 + r1))),
               "fires": fault.fire_count("executor.grads"),
               "params": len(main.parameters()),
               "overlap": str(next(iter(exe._cache.values()))
                              .dist.gplan.overlap_path)}
        exe.close()
    finally:
        fault.disarm()
        paddle.static.reset_default_programs()
    return out


def case_chaos(data, device) -> Dict[str, object]:
    """``chaos.anomaly_main``'s drill on this rank: the fault-free run,
    then the run under ``chaos.ANOMALY_CHAOS_SPEC`` with an
    ``AnomalyPolicy`` (skip budget 2, one rollback) over a snapshot
    store every ``save_every`` applied steps, both over
    ``chaos.AnomalyDataset`` through ``DataLoader.fetch_batch``; what
    ``chaos.anomaly_problems`` gates."""
    import json
    import paddle_tpu_torch as paddle
    from .. import observability
    from ..distributed import AnomalyPolicy
    from ..io import DataLoader
    from ..utils import monitor
    from ..utils.checkpoint import SnapshotStore
    from . import chaos, fault
    steps = int(data.get("steps", 12))
    save_every = int(data.get("save_every", 4))
    shape = {"dp": torch.distributed.get_world_size()}
    loader = DataLoader(chaos.AnomalyDataset(), batch_size=chaos.AN_BATCH,
                        shuffle=False)
    main, loss = _program(data, shape)
    exe = paddle.static.Executor()
    ref = chaos.anomaly_run(loader, exe, main, loss, steps)
    ref_params, _, _ = _state(exe, main)
    exe.close()
    paddle.static.reset_default_programs()

    monitor.stat_reset()
    r = torch.distributed.get_rank()
    flight = os.path.join(str(data["outdir"]), f"anomaly_flight{r}.json")
    observability.enable(capacity=4096)
    observability.install_flight_recorder(path=flight, catch_sigterm=False)
    store = SnapshotStore(os.path.join(str(data["outdir"]), "anomaly_ckpt"))
    fault.arm(chaos.ANOMALY_CHAOS_SPEC, seed=0)
    policy = None
    try:
        main, loss = _program(data, shape)
        exe = paddle.static.Executor()
        objects = {"train": exe.sharded_state(main)}
        policy = AnomalyPolicy(store=store, objects=objects, skip_budget=2,
                               rollback_budget=1, sync=True).install()
        got = chaos.anomaly_run(loader, exe, main, loss, steps,
                                policy=policy, store=store, objects=objects,
                                save_every=save_every)
    finally:
        fault.disarm()
        if policy is not None:
            policy.uninstall()
        observability.uninstall_flight_recorder()
        observability.disable()
    res = policy.result()
    stats = monitor.all_stats()
    params, _, _ = _state(exe, main)
    out = {"ref": ref, "got": got, "compiles": exe.compile_count,
           "sentry_skipped": exe.sentry_stats(main)["skipped_steps"],
           "skips": res["skips"], "quarantines": res["quarantines"],
           "blamed": res["ledger"][0]["batch"] if res["ledger"] else -1,
           "rollbacks": res["rollbacks"],
           "resume_step": -1 if res["resume_step"] is None
           else res["resume_step"],
           "param_max_rel": max(
               float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
               for a, b in zip(params, ref_params))}
    for key, stat in (("stat_skips", "anomaly.skips"),
                      ("stat_quarantines", "anomaly.quarantines"),
                      ("stat_rollbacks", "anomaly.rollbacks"),
                      ("nonfinite_blocks", "grad_comm.nonfinite_blocks"),
                      ("fired_batch", "fault.fired.dataloader.batch"),
                      ("fired_grads", "fault.fired.executor.grads"),
                      ("fired_wire", "fault.fired.grad_comm.wire")):
        out[key] = stats.get(stat, 0)
    box = {}
    if os.path.exists(flight):
        with open(flight) as f:
            box = json.load(f)
    extra = box.get("extra") or {}
    ledger = extra.get("ledger") or [{}]
    out.update(flight_reason=str(box.get("reason")),
               flight_blamed=ledger[0].get("batch", -1),
               flight_resume_step=(extra.get("anomaly") or {}).get(
                   "resume_step", -1))
    exe.close()
    paddle.static.reset_default_programs()
    return out


CASES = {"mesh_nan": case_mesh_nan, "ef_oracle": case_ef_oracle,
         "hybrid": case_hybrid, "rollback": case_rollback,
         "wire": case_wire, "grads": case_grads, "chaos": case_chaos}


def run(outdir: str, cases, device: str = "cpu"):
    """A rank's entry: join the job, run ``cases`` (names of
    :data:`CASES`) with the sentry on, save the results to
    ``rank<r>.npz``."""
    import paddle_tpu_torch as paddle
    from .. import distributed as dist
    from ..core import placement
    if device == "cpu":
        torch.set_num_threads(1)    # the ranks share the host's cores
    placement.set_default(torch.device(device) if device == "cpu"
                          else None)
    dist.init_parallel_env(device=device)
    r = torch.distributed.get_rank()
    data = dict(np.load(os.path.join(outdir, "inputs.npz")))
    data["outdir"] = outdir
    paddle.set_flags({"anomaly_sentry": True})
    paddle.enable_static()
    res = {}
    for name in cases:
        for k, v in CASES[name](data, device).items():
            res[f"{name}/{k}"] = np.asarray(v)
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
