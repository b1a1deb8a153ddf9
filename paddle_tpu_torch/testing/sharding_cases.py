"""Multi-rank cases of fleet, ZeRO and the gradient-communication stage,
run inside ranks started by :func:`~..distributed.launch.spawn` (the
tests on the CPU over gloo; ``chip_smoke.py --chips 4`` over NCCL).

The model is ``tools/shard_smoke.py``'s GPT-tiny causal LM (hidden 32,
vocab 128, sequence 16, 4 heads, 2 layers) recorded as a static program
(:func:`build_gpt_tiny`), trained through ``fleet.distributed_optimizer``
(AdamW 1e-3) and the static ``Executor``, as ``tools/comm_smoke.py``
trains it: a 0.05 MB fuse budget (several buckets), a 4 KB scatter
threshold, block 256, error feedback on.

:func:`run` is the rank's entry: it joins the job, runs the named cases
on the inputs the caller saved (``inputs.npz``: the program's weights
``w<i>`` and the feeds), and saves what each case returns to
``rank<r>.npz`` in ``outdir`` (scalars and arrays; a dict-valued result
is flattened to ``case/key``).  A rank imports ``torch`` and this
package only.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

__all__ = ["build_gpt_tiny", "train_comm", "run", "CASES"]

H, V, S, NH = 32, 128, 16, 4
_AXIS_STATS = ("comm.axis.dp.wire_bytes", "comm.axis.mp.wire_bytes",
               "comm.gather.wire_bytes", "comm.gather.collectives")


def build_gpt_tiny():
    """GPT-tiny (``tools/shard_smoke.build_gpt_tiny``) recorded as a
    static program of this package: ``(program, loss)``.  Parameters in
    the same order as paddle_tpu's recording, so weights carry over by
    position."""
    from .. import nn, static
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    Dh = H // NH

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(H)
            self.ln2 = nn.LayerNorm(H)
            self.qkv = nn.Linear(H, 3 * H)
            self.proj = nn.Linear(H, H)
            self.fc1 = nn.Linear(H, 4 * H)
            self.fc2 = nn.Linear(4 * H, H)

        def forward(self, x):
            qkv = self.qkv(self.ln1(x)).reshape([-1, S, 3, NH, Dh])
            q, k, v = qkv.unbind(axis=2)
            att = paddle.matmul(q.transpose([0, 2, 1, 3]),
                                k.transpose([0, 2, 3, 1]))
            att = att * (1.0 / np.sqrt(Dh))
            mask = paddle.to_tensor(np.triu(
                np.full((S, S), -1e9, np.float32), k=1))
            att = att + mask
            att = F.softmax(att, axis=-1)
            o = paddle.matmul(att, v.transpose([0, 2, 1, 3]))
            o = o.transpose([0, 2, 1, 3]).reshape([-1, S, H])
            x = x + self.proj(o)
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))

    main = static.Program()
    with static.program_guard(main):
        ids = static.data("ids", [None, S], "int64")
        labels = static.data("labels", [None, S], "int64")
        x = nn.Embedding(V, H)(ids) \
            + nn.Embedding(S, H)(paddle.arange(S).unsqueeze(0))
        blocks = [Block() for _ in range(2)]
        ln_f = nn.LayerNorm(H)
        for blk in blocks:
            x = blk(x)
        logits = nn.Linear(H, V)(ln_f(x))
        loss = F.cross_entropy(logits.reshape([-1, V]),
                               labels.reshape([-1]))
    return main, loss


def gpt_feeds(seed: int = 0) -> Dict[str, np.ndarray]:
    """``tools/shard_smoke._feeds("gpt")``: batch 16."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (16, S)).astype(np.int64)
    labels = rng.randint(0, V, (16, S)).astype(np.int64)
    return {"ids": ids, "labels": labels}


def train_comm(weights, feed, dtype, steps, overlap="auto", zero3=False,
               fuse_mb=0.05, mesh_shape=None, return_exe=False,
               constants=(), mp_shard=False):
    """GPT-tiny from ``weights`` and ``constants`` (paddle_tpu's, by
    position: the position embedding is recorded as a constant) through
    fleet + the static Executor with the given grad_comm wire dtype
    (None: no grad_comm) and overlap mode, as ``tools/comm_smoke.py``
    trains it.  ``mp_shard`` cuts every 2-D weight on its output dim
    over 'mp' (comm_smoke's hybrid rows).  Returns the losses, the
    measured and predicted wire
    bytes a step (total and per axis), the compile count, the bucket
    count and algorithms, the residual buckets and the perf split."""
    import paddle_tpu_torch as paddle
    from .. import distributed as dist, optimizer
    from ..distributed.mesh import init_mesh
    from ..framework_io import program_state_from_paddle_tpu
    from ..observability import disable_perf, enable_perf, perf_report
    from ..static.analysis.cost import compile_summary
    from ..utils import monitor

    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    mesh_shape = dict(mesh_shape or {"dp": world})
    init_mesh(mesh_shape)
    paddle.enable_static()
    try:
        # comm_smoke's seed: without paddle_tpu's constants every build
        # still records the same position embedding
        paddle.seed(7)
        main, loss = build_gpt_tiny()
        program_state_from_paddle_tpu(main, weights, constants)
        with paddle.static.program_guard(main):
            f = dist.fleet
            strategy = dist.DistributedStrategy()
            strategy.fuse_grad_size_in_MB = fuse_mb
            if dtype is not None:
                strategy.grad_comm = {"dtype": dtype, "error_feedback": True,
                                      "block_size": 256,
                                      "scatter_threshold_KB": 4.0,
                                      "overlap": overlap}
            if zero3:
                strategy.sharding = True
                strategy.sharding_configs = {"stage": 3,
                                             "min_shard_numel": 1}
            f.init(is_collective=True, strategy=strategy)
            opt = f.distributed_optimizer(
                optimizer.AdamW(learning_rate=1e-3))
            opt.minimize(loss)
        # fleet.init derives the mesh from the strategy: pin the asked one
        init_mesh(mesh_shape)
        if mp_shard:
            import re
            main._sharding_rules = [
                (re.escape(p.name) + "$", (None, "mp"))
                for p in main.parameters() if len(p.shape) == 2
            ] + [(r".*", ())]
        exe = paddle.static.Executor()
        enable_perf(sample_every=1, memory=False)
        w0 = monitor.get_stat("comm.wire_bytes") or 0
        c0 = monitor.get_stat("comm.collectives") or 0
        ax0 = {k: monitor.get_stat(k) or 0 for k in _AXIS_STATS}
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(steps)]
        wire = ((monitor.get_stat("comm.wire_bytes") or 0) - w0) / steps
        colls = ((monitor.get_stat("comm.collectives") or 0) - c0) / steps
        ax = {k: ((monitor.get_stat(k) or 0) - ax0[k]) / steps
              for k in _AXIS_STATS}
        plan = exe._plan_for(main, main.parameters())
        rep = main.analyze(fetch_list=[loss], sharding=plan)
        comm = rep.totals["comm"]
        cs = compile_summary(main, sharding=plan, place=exe.place) or {}
        perf = perf_report()
        split = next((r.get("comm") for r in perf.get("identities", [])
                      if r["component"] == "executor" and r.get("comm")),
                     None)
        disable_perf()
        state = exe._states[main._serial]
        # what a rank holds between runs, beside the cost model's
        # per-shard price (ZeRO-3 params rest as this rank's rows)
        ms = rep.memory_per_shard
        resident = {
            "resident_param_bytes": sum(p.numel() * p.element_size()
                                        for p in main.parameters()),
            "predicted_param_bytes": ms.param_bytes,
            "resident_slot_bytes": sum(
                t.numel() * t.element_size() for sl in state.slots.values()
                for t in sl.values()),
            "predicted_slot_bytes": ms.slot_bytes}
        exe.sync_params(main)
        out = {
            "losses": np.asarray(losses),
            "compiles": exe.compile_count,
            "wire_bytes_per_step": wire,
            "collectives_per_step": colls,
            "predicted_wire_bytes": comm["wire_bytes_per_step"],
            "predicted_fp32_wire_bytes": comm["fp32_wire_bytes_per_step"],
            "axis_dp_wire_bytes": ax["comm.axis.dp.wire_bytes"],
            "axis_mp_wire_bytes": ax["comm.axis.mp.wire_bytes"],
            "predicted_axis_mp": (comm.get("axis_wire_bytes") or {}).get(
                "mp", 0),
            "predicted_axis_dp": (comm.get("axis_wire_bytes") or {}).get(
                "dp", 0),
            "gather_wire_bytes_per_step": ax["comm.gather.wire_bytes"],
            "predicted_gather_wire_bytes": comm.get(
                "gather_wire_bytes_per_step", 0),
            "gather_collectives_per_step": ax["comm.gather.collectives"],
            "peak_bytes_per_shard": cs.get("peak_bytes_per_shard", 0),
            "overlap_path": json.dumps(comm.get("overlap_path")),
            "buckets": len(comm["collectives"]),
            "algorithms": json.dumps(sorted(
                {c["algorithm"] for c in comm["collectives"]})),
            "residual_buckets": len(state.ef),
            "hidden_ms": -1.0 if split is None else split["hidden_ms"],
            **resident,
            "params": np.concatenate([p.detach().float().cpu().reshape(-1)
                                      .numpy() for p in main.parameters()]),
        }
        if return_exe:
            return out, exe, main, loss
        exe.close()
        return out
    finally:
        paddle.disable_static()


# ------------------------------------------------------------- the cases
def _weights(data):
    return [data[f"w{i}"] for i in range(int(data["n_weights"]))]


def _constants(data):
    return [data[f"c{i}"] for i in range(int(data["n_constants"]))]


def _feed(data):
    return {"ids": data["ids"], "labels": data["labels"]}


def case_comm(data, device) -> Dict[str, object]:
    """comm_smoke's configurations at dp = world: fp32, int8 under each
    overlap mode, and ZeRO-3 int8 (auto and none)."""
    out = {}
    w, feed = _weights(data), _feed(data)
    steps = int(data["steps"])
    for tag, kw in (("fp32", dict(dtype="fp32")),
                    ("int8_auto", dict(dtype="int8")),
                    ("int8_none", dict(dtype="int8", overlap="none")),
                    ("int8_ring", dict(dtype="int8", overlap="ring")),
                    ("z3_auto", dict(dtype="int8", zero3=True)),
                    ("z3_none", dict(dtype="int8", zero3=True,
                                     overlap="none")),
                    ("bf16", dict(dtype="bf16")),
                    ("plain", dict(dtype=None)),
                    ("plain_z3", dict(dtype=None, zero3=True))):
        res = train_comm(w, feed, steps=steps, constants=_constants(data),
                         **kw)
        for k, v in res.items():
            out[f"{tag}.{k}"] = v
    return out


def _fc_program(gc=None, zero3=False, seed=7, sum_loss=False, lr=1e-2):
    """``tests/test_distributed.py``'s ``_grad_comm_fc_program``: fc(8 ->
    1), mse (or a sum of squares), Adam through fleet with ``gc`` as
    ``strategy.grad_comm``."""
    import paddle_tpu_torch as paddle
    from .. import distributed as dist, optimizer
    import paddle_tpu_torch.nn.functional as F
    paddle.seed(seed)
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [None, 8], "float32")
        y = paddle.static.data("y", [None, 1], "float32")
        pred = paddle.static.nn.fc(x, 1)
        if sum_loss:
            diff = pred - y
            loss = paddle.sum(diff * diff)
        else:
            loss = F.mse_loss(pred, y)
        s = dist.DistributedStrategy()
        if gc is not None:
            s.grad_comm = gc
        if zero3:
            s.sharding = True
            s.sharding_configs = {"stage": 3, "min_shard_numel": 1}
        dist.fleet.init(is_collective=True, strategy=s)
        opt = dist.fleet.distributed_optimizer(
            optimizer.Adam(learning_rate=lr))
        opt.minimize(loss)
    return main, loss


def _fc_weights(main, data, tag):
    from ..framework_io import program_state_from_paddle_tpu
    program_state_from_paddle_tpu(main, [data[f"{tag}_w"], data[f"{tag}_b"]])


def case_fc(data, device) -> Dict[str, object]:
    """The fc program's grad_comm cases: int8 against no grad_comm
    (losses, wire stats against the prediction, the residual carry),
    fp32 with and without ZeRO-3 (bitwise), the sum loss refused, and
    the overlap flip (a rebuild named new_sharding, the residuals
    restarted from zeros, the bucket stats)."""
    import paddle_tpu_torch as paddle
    from ..observability import explain_compiles
    from ..utils import monitor
    out = {}
    feed = {"x": data["fc_x"], "y": data["fc_y"]}
    paddle.enable_static()
    try:
        for mode in ("none", "int8"):
            gc = (None if mode == "none" else
                  {"dtype": "int8", "scatter_threshold_KB": 0.01,
                   "block_size": 64})
            main, loss = _fc_program(gc)
            _fc_weights(main, data, "fc")
            exe = paddle.static.Executor()
            w0 = monitor.get_stat("comm.wire_bytes") or 0
            c0 = monitor.get_stat("comm.collectives") or 0
            out[f"{mode}.losses"] = [float(exe.run(
                main, feed=feed, fetch_list=[loss])[0]) for _ in range(5)]
            out[f"{mode}.compiles"] = exe.compile_count
            out[f"{mode}.wire"] = (monitor.get_stat("comm.wire_bytes")
                                   or 0) - w0
            out[f"{mode}.colls"] = (monitor.get_stat("comm.collectives")
                                    or 0) - c0
            plan = exe._plan_for(main, main.parameters())
            comm = main.analyze(fetch_list=[loss],
                                sharding=plan).totals["comm"]
            out[f"{mode}.pred_wire"] = comm["wire_bytes_per_step"]
            out[f"{mode}.pred_colls"] = comm.get("collectives_per_step", 0)
            out[f"{mode}.comm"] = json.dumps(comm, sort_keys=True)
            st = exe._states[main._serial]
            out[f"{mode}.ef_shapes"] = json.dumps(
                [list(r.shape) for r in st.ef])
            exe.close()
        for zero3 in (False, True):
            main, loss = _fc_program({"dtype": "fp32",
                                      "scatter_threshold_KB": 0.0},
                                     zero3=zero3, seed=11)
            _fc_weights(main, data, "fc")
            exe = paddle.static.Executor()
            out[f"z{int(zero3)}.losses"] = [float(exe.run(
                main, feed=feed, fetch_list=[loss])[0]) for _ in range(5)]
            exe.sync_params(main)
            out[f"z{int(zero3)}.params"] = np.concatenate(
                [p.detach().cpu().numpy().ravel()
                 for p in main.parameters()])
            out[f"z{int(zero3)}.compiles"] = exe.compile_count
            plan = exe._plan_for(main, main.parameters())
            out[f"z{int(zero3)}.specs"] = json.dumps(
                [list(s) for s in plan.param_specs])
            exe.close()
        main, loss = _fc_program({"dtype": "int8"}, sum_loss=True)
        exe = paddle.static.Executor()
        try:
            exe.run(main, feed=feed, fetch_list=[loss])
            out["sum_loss"] = ""
        except NotImplementedError as e:
            out["sum_loss"] = str(e)
        exe.close()
        # the overlap flip: auto (poisoned carry) -> none, against
        # none from scratch with the carry zeroed after step 1
        gc = {"dtype": "int8", "scatter_threshold_KB": 0.01,
              "block_size": 64, "overlap": "auto"}

        def fresh(overlap):
            main, loss = _fc_program(dict(gc, overlap=overlap), seed=7)
            _fc_weights(main, data, "fc")
            return main, loss, paddle.static.Executor()

        main, loss, exe = fresh("auto")
        w0 = {k: monitor.get_stat(k) or 0
              for k in ("comm.bucket.0.wire_bytes",
                        "comm.algo.scatter.wire_bytes")}
        la = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])]
        plan = exe._plan_for(main, main.parameters())
        comm = main.analyze(fetch_list=[loss], sharding=plan).totals["comm"]
        out["flip.bucket0"] = ((monitor.get_stat("comm.bucket.0.wire_bytes")
                                or 0) - w0["comm.bucket.0.wire_bytes"])
        out["flip.bucket0_pred"] = comm["collectives"][0]["wire_bytes"]
        out["flip.scatter"] = ((monitor.get_stat(
            "comm.algo.scatter.wire_bytes") or 0)
            - w0["comm.algo.scatter.wire_bytes"])
        out["flip.pred"] = comm["wire_bytes_per_step"]
        st = exe._states[main._serial]
        k1 = st.ef_key
        st.ef = [torch.ones_like(r) for r in st.ef]
        from .. import distributed as dist
        strat2 = dist.DistributedStrategy()
        strat2.grad_comm = dict(gc, overlap="none")
        main._optimizer[0]._dist_strategy = strat2
        c_before = exe.compile_count
        la += [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
               for _ in range(2)]
        out["flip.rebuilds"] = exe.compile_count - c_before
        out["flip.key_moved"] = int(exe._states[main._serial].ef_key != k1)
        recs = [r for r in explain_compiles("executor")["records"]
                if r["identity"] == main._serial]
        out["flip.cause"] = recs[-1]["cause"]
        out["flip.path"] = recs[-1]["comm"]["path"]
        out["flip.buckets_match"] = int(recs[-1]["comm"]["buckets"]
                                        == comm["collectives"])
        exe.close()
        main, loss, exe = fresh("none")
        lc = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])]
        st = exe._states[main._serial]
        st.ef = [torch.zeros_like(r) for r in st.ef]
        lc += [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
               for _ in range(2)]
        exe.close()
        main, loss, exe = fresh("none")
        exe.run(main, feed=feed, fetch_list=[loss])
        st = exe._states[main._serial]
        st.ef = [torch.ones_like(r) for r in st.ef]
        ld = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
              for _ in range(2)]
        exe.close()
        out["flip.la"], out["flip.lc"], out["flip.ld"] = la, lc, ld
    finally:
        paddle.disable_static()
    return out


def case_reduce(data, device) -> Dict[str, object]:
    """``reduce_gradients`` itself on each rank's rows of
    ``red_g<i>``: every overlap path at fp32 and int8 (the fused and the
    ring routes), and the error-feedback telescoping on the gathered
    and the FSDP routes (24 steps with and without the residual)."""
    from ..distributed import grad_comm as gc
    r = torch.distributed.get_rank()
    dp = torch.distributed.get_world_size()
    shapes = [tuple(int(d) for d in data[f"red_shape{i}"])
              for i in range(3)]
    grads = [torch.from_numpy(data[f"red_g{i}"][r]) for i in range(3)]
    out = {}
    for dtype, ef in (("fp32", False), ("int8", True)):
        cfg = gc.CommSpec(dtype, 32, ef, 0.0, 32.0, "grad_comm")
        plan = gc.plan_reduction(shapes, dp=dp, cfg=cfg)
        for mode in ("xla", "ring", "none"):
            res = ([torch.zeros(b.numel) for b in plan.residual_buckets]
                   if ef else None)
            red, _ = gc.reduce_gradients(grads, plan=plan, residuals=res,
                                         mode=mode)
            for i, t in enumerate(red):
                out[f"{dtype}.{mode}.{i}"] = t.numpy()
    n, T = 96, 24
    g = torch.from_numpy(data["ef_g"][r])
    for route in ("gathered", "fsdp"):
        cfg = gc.CommSpec("int8", 32, True, 0.0, 32.0, "grad_comm")
        plan = gc.plan_reduction([(n,)], dp=dp, cfg=cfg,
                                 fsdp=(0,) if route == "fsdp" else ())
        b = plan.buckets[0]
        flat_n = gc.bucket_flat_numel(b, dp, plan.cfg.block_size)
        for use_res in (True, False):
            res = torch.zeros(flat_n)
            applied = torch.zeros(n if route == "gathered" else n // dp,
                                  dtype=torch.float64)
            for _ in range(T):
                red, new = gc.reduce_gradients(
                    [g], plan=plan, residuals=[res] if use_res else None)
                if use_res:
                    res = new[0]
                applied += red[0].double()
            out[f"ef.{route}.{int(use_res)}"] = applied.numpy()
        out[f"ef.{route}.algo"] = b.algorithm
    return out


def case_zero(data, device) -> Dict[str, object]:
    """ZeRO stages 1-3 on ``SpmdTrainStep`` (Linear 8-32-GELU-32-8 and
    Linear 7-13-Tanh-13-5 at stage 3 with padding) and the grad_comm
    SpmdTrainStep (int8 and the bf16 alias) on a Linear 8-8, from the
    caller's weights."""
    import paddle_tpu_torch as paddle
    from .. import distributed as dist, nn, optimizer
    from ..parallel import SpmdTrainStep
    import paddle_tpu_torch.nn.functional as F
    out = {}
    mse = lambda o, l: F.mse_loss(o, l)  # noqa: E731
    for tag, dims, act in (("a", (8, 32, 8), nn.GELU),
                           ("b", (7, 13, 5), nn.Tanh)):
        for stage in (1, 2, 3):
            net = nn.Sequential(nn.Linear(dims[0], dims[1]), act(),
                                nn.Linear(dims[1], dims[2]))
            net.set_state_dict({k: torch.from_numpy(data[f"z{tag}.{k}"])
                                for k in net.state_dict()})
            strat = dist.DistributedStrategy()
            strat.sharding = True
            strat.sharding_configs = {"stage": stage, "min_shard_numel": 1}
            opt = optimizer.Adam(learning_rate=0.01,
                                 parameters=net.parameters())
            step = SpmdTrainStep(net, mse, opt, strategy=strat)
            x = paddle.to_tensor(data[f"z{tag}.x"])
            y = paddle.to_tensor(data[f"z{tag}.y"])
            out[f"{tag}{stage}.losses"] = [float(step(x, y))
                                           for _ in range(3)]
            # between steps a ZeRO-3 param holds this rank's rows only
            out[f"{tag}{stage}.resident"] = sum(
                p.numel() * p.element_size() for p in net.parameters())
            # padding rows (the tail of the last rank's block) stay 0
            last = step.dp.rank == step.dp.nranks - 1
            pads = [t[t.shape[0] - (pd0 - d0):]
                    for i, (d0, pd0) in step._padded.items()
                    for t in [step._p_store[i]] if last]
            out[f"{tag}{stage}.pad_rows_zero"] = int(all(
                bool((t == 0).all()) for t in pads))
            # state_dict gives the model its full values first
            out[f"{tag}{stage}.params"] = np.concatenate(
                [v.detach().numpy().ravel()
                 for v in net.state_dict().values()])
            out[f"{tag}{stage}.specs"] = json.dumps(
                [list(step._param_spec(i, p))
                 for i, p in enumerate(step._params)])
            out[f"{tag}{stage}.padded"] = json.dumps(
                {str(k): list(v) for k, v in step._padded.items()})
            out[f"{tag}{stage}.slot_rows"] = json.dumps(
                [list(s["m"].shape) for s in step._opt_state])
    for spelling in ("int8", "alias", "bf16"):
        net = nn.Linear(8, 8)
        net.set_state_dict({k: torch.from_numpy(data[f"gc.{k}"])
                            for k in net.state_dict()})
        strat = dist.DistributedStrategy()
        if spelling == "alias":
            strat.fp16_allreduce = True
        elif spelling == "bf16":
            strat.grad_comm = {"dtype": "bf16", "error_feedback": False}
        else:
            strat.grad_comm = {"dtype": "int8", "error_feedback": False,
                               "scatter_threshold_KB": 0.01,
                               "block_size": 32}
        opt = optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
        step = SpmdTrainStep(net, mse, opt, strategy=strat)
        x = paddle.to_tensor(data["gc.x"])
        y = paddle.to_tensor(data["gc.y"])
        for _ in range(3):
            step(x, y)
        out[f"gc.{spelling}.weight"] = net.weight.detach().numpy()
        out[f"gc.{spelling}.wires"] = json.dumps(
            [b.wire_dtype for b in step._comm_plan.buckets])
    return out


def case_tree(data, device) -> Dict[str, object]:
    """``shard_tree`` keeps each rank's block, ``gather_tree`` gives the
    full arrays back on every rank."""
    from ..distributed import sharding as sh
    from ..distributed.mesh import PartitionSpec as P, init_mesh
    mesh = init_mesh({"dp": torch.distributed.get_world_size()})
    tree = {"w": data["tree_w"], "b": data["tree_b"]}
    placed = sh.shard_tree(tree, rules=[(r"w$", P("dp")), (r".*", P())],
                           mesh=mesh)
    back = sh.gather_tree(placed)
    return {"w_local": placed["w"].numpy(),
            "w_spec": json.dumps(list(placed["w"].sharding.spec)),
            "w_back": back["w"], "b_back": back["b"]}


def case_snapshot(data, device) -> Dict[str, object]:
    """The fc program under ZeRO-3 (no grad_comm) through fleet at dp =
    world: 3 runs, a ``SnapshotStore`` save of ``Executor.
    sharded_state``, 3 more runs; and the same program without fleet on
    the full batch, as the plain reference.  Returns the params at the
    save, the continuation's losses, both loss lists and the build
    count."""
    import paddle_tpu_torch as paddle
    from ..utils.checkpoint import SnapshotStore
    out = {}
    feed = {"x": data["snap_x"], "y": data["snap_y"]}
    paddle.enable_static()
    try:
        main, loss = _fc_program(zero3=True, seed=0, lr=0.05)
        _fc_weights(main, data, "snap")
        exe = paddle.static.Executor()
        out["losses"] = [float(exe.run(main, feed=feed,
                                       fetch_list=[loss])[0])
                         for _ in range(3)]
        store = SnapshotStore(str(data["ckpt_dir"]))
        store.save(0, {"train": exe.sharded_state(main)})
        exe.sync_params(main)
        out["params"] = np.concatenate([p.detach().cpu().numpy().ravel()
                                        for p in main.parameters()])
        out["cont"] = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                       for _ in range(3)]
        out["compiles"] = exe.compile_count
        plan = exe._plan_for(main, main.parameters())
        out["specs"] = json.dumps([list(s) for s in plan.param_specs])
        exe.close()
        # the same program without fleet: every rank on the full batch
        from .. import optimizer
        import paddle_tpu_torch.nn.functional as F
        paddle.seed(0)
        plain = paddle.static.Program()
        with paddle.static.program_guard(plain):
            x = paddle.static.data("x", [None, 8], "float32")
            y = paddle.static.data("y", [None, 1], "float32")
            ploss = F.mse_loss(paddle.static.nn.fc(x, 1), y)
            optimizer.Adam(learning_rate=0.05).minimize(ploss)
        _fc_weights(plain, data, "snap")
        pexe = paddle.static.Executor()
        out["plain"] = [float(pexe.run(plain, feed=feed,
                                       fetch_list=[ploss])[0])
                        for _ in range(6)]
        pexe.close()
    finally:
        paddle.disable_static()
    return out


def case_fleet(data, device) -> Dict[str, object]:
    """``fleet.util`` and ``save_persistables`` over the job: every
    rank's value summed (max, min), a tensor kept a tensor; a ZeRO-3
    ``get_train_step`` model saved once, by rank 0, with its full
    values, readable on every rank when the call returns."""
    import paddle_tpu_torch as paddle
    from .. import distributed as dist, framework_io, nn, optimizer
    import paddle_tpu_torch.nn.functional as F
    r = torch.distributed.get_rank()
    f = dist.fleet
    strat = dist.DistributedStrategy()
    strat.sharding = True
    strat.sharding_configs = {"stage": 3, "min_shard_numel": 1}
    f.init(is_collective=True, strategy=strat)
    u = f.util
    out = {f"util.{m}": u.all_reduce(np.array([1.0, r + 1.0]), m)
           for m in ("sum", "max", "min")}
    t = u.all_reduce(torch.tensor([float(r), 2.0]))
    out["util.tensor"] = t.numpy()
    out["util.tensor_kind"] = int(isinstance(t, torch.Tensor))
    out["util.file_shard"] = json.dumps(u.get_file_shard(list("abcde")))
    paddle.seed(3)
    net = nn.Linear(4, 6)
    net.set_state_dict({k: torch.from_numpy(data[f"fleet.{k}"])
                        for k in net.state_dict()})
    f.distributed_model(net)
    opt = f.distributed_optimizer(optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()))
    step = f.get_train_step(net, lambda o, l: F.mse_loss(o, l), opt)
    step(paddle.to_tensor(data["fleet.x"]), paddle.to_tensor(data["fleet.y"]))
    out["resting_shape"] = json.dumps(list(net.weight.shape))
    writes = []
    save = framework_io.save

    def counted(*a, **k):
        writes.append(1)
        return save(*a, **k)

    framework_io.save = counted
    try:
        f.save_persistables(dirname=str(data["fleet_dir"]))
    finally:
        framework_io.save = save
    out["writes"] = len(writes)
    saved = framework_io.load(os.path.join(str(data["fleet_dir"]),
                                           "model.pdparams"))
    for k, v in saved.items():
        out[f"saved.{k}"] = np.asarray(v)
    return out


CASES = {"comm": case_comm, "fc": case_fc, "reduce": case_reduce,
         "zero": case_zero, "tree": case_tree, "snapshot": case_snapshot,
         "fleet": case_fleet}


def run(outdir: str, cases, device: str = "cpu"):
    """A rank's entry: join the job, run ``cases`` (names of
    :data:`CASES`), save the results to ``rank<r>.npz``."""
    from .. import distributed as dist
    from ..core import placement
    if device == "cpu":
        torch.set_num_threads(1)    # the ranks share the host's cores
    placement.set_default(torch.device(device) if device == "cpu"
                          else None)
    dist.init_parallel_env(device=device)
    r = torch.distributed.get_rank()
    data = dict(np.load(os.path.join(outdir, "inputs.npz")))
    res = {}
    for name in cases:
        for k, v in CASES[name](data, device).items():
            res[f"{name}/{k}"] = np.asarray(v)
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
