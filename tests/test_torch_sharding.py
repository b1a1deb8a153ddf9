"""Sharding (``paddle_tpu_torch.distributed.sharding``) and ZeRO 1-3
held to paddle_tpu's.

Pure parts against the JAX package: the partition-rule engine (first
match wins, scalars replicate, the nearest-rule error text), the spec
layout and divisor, the spec JSON, ``specs_for_state``,
``plan_for_params``'s ZeRO-3 default (dim 0 over 'dp' when it divides
and the tensor has ``min_shard_numel`` elements), per-shard pricing in
``analyze(sharding=plan)`` and the mesh-replace guard.

One gloo world of 4 CPU ranks per module (``testing.sharding_cases``):

- ``SpmdTrainStep`` at ZeRO stages 1, 2 and 3 (stage 3 also with the
  padded odd shapes of ``tests/test_strategy_toggles.py``) against the
  local ``TrainStep`` and paddle_tpu's ``SpmdTrainStep`` on the same
  mesh shape: losses within rtol 2e-4 (paddle_tpu's own tolerance),
  parameters within 2e-4 / 1e-6;
- ``shard_tree`` / ``gather_tree`` round trip;
- the fc program under ZeRO-3 through fleet: the same losses as the
  program without fleet (rtol 1e-5), one build, and a ``SnapshotStore``
  snapshot of ``Executor.sharded_state`` that this process (one rank,
  mesh {dp: 1}) restores bitwise and continues within rtol 1e-5 of the
  four ranks; a flipped byte in one block is caught.

The grad_comm ``SpmdTrainStep`` (int8, and the bf16 alias
``fp16_allreduce``) rides the same world: it changes the numerics, stays
close to fp32, and the alias trains bitwise as ``grad_comm.dtype=
'bf16'`` (``tests/test_strategy_toggles.py`` and
``tests/test_distributed.py`` twins).
"""
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from jax.sharding import PartitionSpec as JP
from paddle_tpu import distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import sharding as jsh
from paddle_tpu_torch.distributed import sharding as tsh
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.distributed.mesh import PartitionSpec as TP
from paddle_tpu_torch.testing import sharding_cases

DP = 4


def _mesh(shape):
    """A stand-in mesh of the given shape (the pure tests need no
    process group)."""
    n = int(np.prod(list(shape.values())))
    return types.SimpleNamespace(shape=dict(shape), size=n,
                                 ranks=np.arange(n).reshape(
                                     tuple(shape.values())))


@pytest.fixture
def cpu():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import placement
    prev = placement.default()
    pt.set_device("cpu")
    yield pt
    placement.set_default(prev)


@pytest.fixture(scope="module", autouse=True)
def _end_the_one_rank_job():
    """``fleet.init`` in this process joins a one-rank gloo job; end it
    with the module."""
    yield
    from paddle_tpu_torch import distributed as dist
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    dist.set_mesh(None)


# ---------------------------------------------------------------- pure
def test_partition_rules_are_paddle_tpus():
    """First match wins, scalar and one-element leaves replicate, an
    unmatched leaf raises paddle_tpu's message with the nearest rule
    (``strict=False`` replicates), on both packages."""
    from paddle_tpu.core.enforce import InvalidArgumentError as JErr
    from paddle_tpu_torch.core.enforce import InvalidArgumentError as TErr
    tree = {"block": {"weight": np.ones((8, 4), np.float32)}}
    for rules in ([(r"block/weight", "dp"), (r"weight", (None, "dp"))],
                  [(r"weight", (None, "dp")), (r"block/weight", "dp")]):
        j = jsh.match_partition_rules(
            [(p, JP(*((s,) if isinstance(s, str) else s)))
             for p, s in rules], tree)
        t = tsh.match_partition_rules(rules, tree)
        assert tuple(t["block"]["weight"]) == tuple(j["block"]["weight"])
    tree = {"w": np.ones((8, 2), np.float32), "step": np.float32(3.0),
            "one": np.ones((1,), np.float32)}
    t = tsh.match_partition_rules([(r".*", TP("dp"))], tree)
    assert t["w"] == TP("dp") and t["step"] == TP() and t["one"] == TP()
    tree = {"encoder": {"attn_weight": np.ones((8, 8), np.float32)}}
    rules = [(r"atn_weight$", "dp"), (r"bias$", None)]
    with pytest.raises(JErr) as je:
        jsh.match_partition_rules([(r"atn_weight$", JP("dp")),
                                   (r"bias$", JP())], tree)
    with pytest.raises(TErr) as te:
        tsh.match_partition_rules(rules, tree)
    assert str(te.value) == str(je.value)
    assert "catch-all" in str(te.value)
    assert tsh.match_partition_rules(rules, tree, strict=False)[
        "encoder"]["attn_weight"] == TP()
    pairs = [("a", np.ones((4, 4), np.float32)),
             ("b", np.ones((3,), np.float32))]
    assert tsh.match_partition_rules([(r"a", "dp"), (r".*", None)],
                                     pairs) == [("a", TP("dp")),
                                                ("b", TP())]


def test_spec_layout_divisor_json_and_state_specs():
    """``SpecLayout``, ``spec_divisor``, the spec JSON round trip and
    ``specs_for_state`` (slots of the param's shape inherit its spec)
    give paddle_tpu's answers."""
    tl, jl = tsh.SpecLayout(), jsh.SpecLayout()
    for m in ("replicated", "embedding", "column_parallel", "row_parallel",
              "fsdp", "norm", "activations"):
        assert tuple(getattr(tl, m)()) == tuple(getattr(jl, m)())
    assert [(p, tuple(s)) for p, s in tl.rules()] == \
        [(p, tuple(s)) for p, s in jl.rules()]
    for spec, mesh in ((("dp",), {"dp": 8}),
                       ((("dp", "mp"), None), {"dp": 2, "mp": 4}),
                       ((None, "mp"), {"dp": 8})):
        assert tsh.spec_divisor(TP(*spec), mesh) == \
            jsh.spec_divisor(JP(*spec), mesh)
        js = jsh.spec_to_json(JP(*spec))
        assert tsh.spec_to_json(TP(*spec)) == js
        assert tuple(tsh.spec_from_json(js)) == tuple(
            jsh.spec_from_json(js))
    state = [{"m": np.ones((8, 4), np.float32),
              "v": np.ones((8, 4), np.float32),
              "beta1_pow": np.float32(0.9)},
             {"m": np.ones((4, 8), np.float32)}]
    t = tsh.specs_for_state([TP("dp"), TP(None, "mp")], state,
                            param_shapes=[(8, 4), (4, 8)])
    j = jsh.specs_for_state([JP("dp"), JP(None, "mp")], state,
                            param_shapes=[(8, 4), (4, 8)])
    assert [{k: tuple(v) for k, v in e.items()} for e in t] == \
        [{k: tuple(v) for k, v in e.items()} for e in j]
    tree = {"embedding_0": {"w_0": np.ones((64, 8), np.float32)},
            "linear_0": {"w_0": np.ones((8, 8), np.float32),
                         "b_0": np.ones((8,), np.float32)}}
    t = tsh.match_partition_rules(tl.rules(), tree)
    assert t["embedding_0"]["w_0"] == tl.embedding()
    assert t["linear_0"]["b_0"] == TP()


@pytest.mark.parametrize("min_numel", [1, 64])
def test_zero3_plan_for_params_is_paddle_tpus(min_numel):
    """``plan_for_params`` under ZeRO-3 at {dp: 4}: dim 0 over 'dp'
    where it divides and the tensor has ``min_shard_numel`` elements,
    else replicated, with the fitted specs and the resolved grad_comm
    spec of paddle_tpu's plan; a spec the mesh cannot carry downgrades
    the same way."""
    from paddle_tpu_torch.distributed import DistributedStrategy as TS
    shapes = [(8, 4), (6, 2), (4,), (1,), (16, 16), (3,)]
    arrays = [np.zeros(s, np.float32) for s in shapes]
    named = [(f"p{i}", a) for i, a in enumerate(arrays)]
    specs = {}
    for pkg, S, sh in ((jdist, jdist.DistributedStrategy, jsh),
                       (None, TS, tsh)):
        s = S()
        s.sharding = True
        s.sharding_configs = {"stage": 3, "min_shard_numel": min_numel}
        s.grad_comm = {"dtype": "int8", "overlap": "ring"}
        if pkg is jdist:
            mesh = jdist.init_mesh({"dp": DP})
            plan = sh.plan_for_params([(n, jnp.asarray(a))
                                       for n, a in named], strategy=s,
                                      mesh=mesh)
        else:
            plan = sh.plan_for_params(named, strategy=s,
                                      mesh=_mesh({"dp": DP}))
        specs[sh] = [tuple(x) for x in plan.param_specs]
        gc = plan.grad_comm.fingerprint()
        assert plan.batch_divisor() == DP
        assert tuple(plan.feed_spec((16, 3))) == ("dp",)
        assert tuple(plan.feed_spec((6, 3))) == ()
    assert specs[tsh] == specs[jsh]
    assert gc == ("int8", 256, True, 32.0, 32.0, "ring")
    down = []
    assert tsh._fit_spec_to_mesh(TP("dp", "mp"), (6, 4), {"dp": 4},
                                 "w", downgrades=down) == TP()
    jdown = []
    assert tuple(jsh._fit_spec_to_mesh(JP("dp", "mp"), (6, 4), {"dp": 4},
                                       "w", downgrades=jdown)) == ()
    assert down == jdown


def test_analyze_prices_a_sharded_program_per_shard(cpu):
    """``test_analyze_prices_sharded_program_per_shard``: the weight
    [32, 1] over dp 8 is 16 B a shard, the bias replicated; slots
    follow; the per-shard peak is below the whole program's and
    ``compile_summary`` carries it; the same numbers as paddle_tpu's
    per-shard params and slots."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.static.analysis.cost import compile_summary
    got = {}
    for pkg in (paddle, cpu):
        pkg.enable_static()
        try:
            pkg.seed(0)
            main = pkg.static.Program()
            with pkg.static.program_guard(main):
                x = pkg.static.data("x", [64, 32], "float32")
                y = pkg.static.data("y", [64, 1], "float32")
                loss = pkg.nn.functional.mse_loss(pkg.static.nn.fc(x, 1), y)
                (jopt if pkg is paddle else optimizer).Adam(
                    learning_rate=0.01).minimize(loss)
            params = main.parameters()
            w = params[0].name
            if pkg is paddle:
                plan = jsh.plan_for_params(
                    [(p.name, p) for p in params],
                    mesh=jdist.init_mesh({"dp": 8}),
                    rules=[(rf"{w}$", JP("dp")), (r".*", JP())])
            else:
                plan = tsh.plan_for_params(
                    [(p.name, p) for p in params], mesh=_mesh({"dp": 8}),
                    rules=[(rf"{w}$", TP("dp")), (r".*", TP())])
            rep = main.analyze(fetch_list=[loss], sharding=plan)
            ms, mf = rep.memory_per_shard, rep.memory
            assert ms.param_bytes == (32 * 4) // 8 + 4
            assert ms.slot_bytes == 2 * ((32 * 4) // 8 + 4)
            assert ms.peak_bytes_donated < mf.peak_bytes_donated
            assert rep.totals["mesh_devices"] == 8
            assert "per-shard" in rep.render()
            got[pkg] = (ms.param_bytes, ms.slot_bytes, ms.grad_bytes)
            if pkg is cpu:
                s = compile_summary(main, sharding=plan)
                assert s["peak_bytes_per_shard"] == ms.peak_bytes_donated
        finally:
            pkg.disable_static()
            if pkg is paddle:
                paddle.static.reset_default_programs()
    assert got[cpu] == got[paddle]


def test_mesh_replace_guard_and_users(cpu):
    """``register_mesh_user`` holds a mesh: replacing it raises
    ``PreconditionNotMetError`` naming the holder, warns under
    ``FLAGS_mesh_replace_warn_only``, and is clean once released."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.core.enforce import PreconditionNotMetError
    mesh = dist.init_mesh({"dp": 1})

    class Holder:
        pass

    h = Holder()
    dist.register_mesh_user(h, mesh, "test executable")
    try:
        assert dist.mesh_users(mesh) == ["test executable"]
        with pytest.raises(PreconditionNotMetError,
                           match="test executable"):
            dist.init_mesh({"dp": 1, "mp": 1})
        cpu.set_flags({"mesh_replace_warn_only": True})
        try:
            with pytest.warns(UserWarning, match="replacing live mesh"):
                dist.init_mesh({"dp": 1, "mp": 1})
        finally:
            cpu.set_flags({"mesh_replace_warn_only": False})
    finally:
        dist.release_mesh_user(h)
    dist.init_mesh({"dp": 1})
    assert dist.mesh_users() == []
    assert dist.named_sharding("dp").spec == TP("dp")
    assert dist.in_spmd() is None and dist.early_init() is None
    assert dist.all_gather_object([], {"a": 1}) == [{"a": 1}]


# ------------------------------------------------------------ the ranks
def _net(tag):
    dims, act = {"a": ((8, 32, 8), jnn.GELU),
                 "b": ((7, 13, 5), jnn.Tanh)}[tag]
    return jnn.Sequential(jnn.Linear(dims[0], dims[1]), act(),
                          jnn.Linear(dims[1], dims[2]))


def _zero_data():
    data = {}
    for tag, seed in (("a", 21), ("b", 31)):
        paddle.seed(seed)
        net = _net(tag)
        for k, v in net.state_dict().items():
            data[f"z{tag}.{k}"] = np.asarray(v.data)
        r = np.random.RandomState(seed)
        n_in = 8 if tag == "a" else 7
        n_out = 8 if tag == "a" else 5
        data[f"z{tag}.x"] = r.randn(16, n_in).astype(np.float32)
        data[f"z{tag}.y"] = r.randn(16, n_out).astype(np.float32)
    paddle.seed(23)
    net = jnn.Linear(8, 8)
    for k, v in net.state_dict().items():
        data[f"gc.{k}"] = np.asarray(v.data)
    r = np.random.RandomState(23)
    data["gc.x"] = r.standard_normal((32, 8)).astype(np.float32)
    data["gc.y"] = r.standard_normal((32, 8)).astype(np.float32)
    return data


def _jax_zero(data, tag, stage):
    """paddle_tpu's SpmdTrainStep at {dp: 4} from the same weights."""
    from paddle_tpu.parallel import SpmdTrainStep
    net = _net(tag)
    net.set_state_dict({k: jnp.asarray(data[f"z{tag}.{k}"])
                        for k in net.state_dict()})
    mesh = jdist.init_mesh({"dp": DP})
    s = jdist.DistributedStrategy()
    s.sharding = True
    s.sharding_configs = {"stage": stage, "min_shard_numel": 1}
    opt = jopt.Adam(learning_rate=0.01, parameters=net.parameters())
    step = SpmdTrainStep(net, lambda o, l: JF.mse_loss(o, l), opt,
                         mesh=mesh, strategy=s)
    x, y = jnp.asarray(data[f"z{tag}.x"]), jnp.asarray(data[f"z{tag}.y"])
    losses = [float(step(x, y)) for _ in range(3)]
    step.sync_params()
    return losses, {k: np.asarray(v.data)
                    for k, v in net.state_dict().items()}, step


def _local(data, tag):
    """The port's local TrainStep from the same weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.jit import TrainStep
    dims, act = {"a": ((8, 32, 8), nn.GELU),
                 "b": ((7, 13, 5), nn.Tanh)}[tag]
    net = nn.Sequential(nn.Linear(dims[0], dims[1]), act(),
                        nn.Linear(dims[1], dims[2]))
    net.set_state_dict({k: torch.from_numpy(data[f"z{tag}.{k}"])
                        for k in net.state_dict()})
    opt = optimizer.Adam(learning_rate=0.01, parameters=net.parameters())
    step = TrainStep(net, lambda o, l: pt.nn.functional.mse_loss(o, l), opt)
    x, y = pt.to_tensor(data[f"z{tag}.x"]), pt.to_tensor(data[f"z{tag}.y"])
    losses = [float(step(x, y)) for _ in range(3)]
    return losses, np.concatenate([v.detach().numpy().ravel()
                                   for v in net.state_dict().values()])


def _snap_data():
    paddle.seed(0)
    jw = np.random.RandomState(0).standard_normal((8, 1)).astype(
        np.float32) * 0.3
    rng = np.random.RandomState(1)
    xs = rng.standard_normal((64, 8)).astype(np.float32)
    ys = (xs @ rng.standard_normal((8, 1))).astype(np.float32)
    return {"snap_w": jw, "snap_b": np.zeros((1,), np.float32),
            "snap_x": xs, "snap_y": ys}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding")
    data = _zero_data()
    data.update(_snap_data())
    data["tree_w"] = np.arange(32, dtype=np.float32).reshape(16, 2)
    data["tree_b"] = np.arange(3, dtype=np.float32)
    data["ckpt_dir"] = np.asarray(str(out / "ckpt"))
    np.savez(out / "inputs.npz", **data)
    spawn(sharding_cases.run, (str(out), ["zero", "tree", "snapshot"]),
          nprocs=DP, init_method=f"file://{out}/store", timeout=300)
    res = [dict(np.load(out / f"rank{i}.npz")) for i in range(DP)]
    return out, data, res


def _get(res, key, rank=0):
    return res[rank][key]


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_match_the_local_step_and_paddle_tpu(ranks, cpu,
                                                         stage):
    """``test_zero_sharding_matches_local`` (stage 2),
    ``test_zero3_param_sharding_parity`` and
    ``test_trainstep_features.py::test_zero2_parity_and_reduce_scatter``:
    ZeRO at dp 4 trains as the local step (losses rtol 2e-4, params
    2e-4 / 1e-6) and as paddle_tpu's SpmdTrainStep on the same mesh
    shape (losses rtol 2e-4); the optimizer slots of every shardable
    param hold a quarter of its rows, the ranks' params agree bitwise;
    at stage 3 the specs are paddle_tpu's."""
    _, data, res = ranks
    g = lambda k, r=0: _get(res, f"zero/a{stage}.{k}", r)  # noqa: E731
    losses, params = _local(data, "a")
    np.testing.assert_allclose(g("losses"), losses, rtol=2e-4)
    np.testing.assert_allclose(g("params"), params, rtol=2e-4, atol=1e-6)
    for r in range(1, DP):
        np.testing.assert_array_equal(g("params", r), g("params"))
    rows = json.loads(str(g("slot_rows")))
    assert rows == [[8 // DP, 32], [32 // DP], [32 // DP, 8], [8 // DP]]
    if stage in (2, 3):
        jl, _, jstep = _jax_zero(data, "a", stage)
        np.testing.assert_allclose(g("losses"), jl, rtol=2e-4)
        if stage == 3:
            jspecs = [list(jstep._param_spec(i, p))
                      for i, p in enumerate(jstep._params)]
            assert json.loads(str(g("specs"))) == jspecs


def test_zero3_pads_odd_params(ranks, cpu):
    """``test_zero3_pads_odd_params``: at dp 4 every param of the 7-13-5
    net shards over 'dp' (dim 0 padded to a multiple of 4: paddle_tpu's
    padding plan), the padding rows stay zero, and the losses and params
    match the local step (rtol 2e-4, atol 1e-6) and paddle_tpu's padded
    step."""
    _, data, res = ranks
    g = lambda k, r=0: _get(res, f"zero/b3.{k}", r)  # noqa: E731
    jl, jp, jstep = _jax_zero(data, "b", 3)
    assert json.loads(str(g("padded"))) == {
        str(k): list(v) for k, v in jstep._padded.items()}
    assert all(s == ["dp"] for s in json.loads(str(g("specs"))))
    assert g("pad_rows_zero", DP - 1) == 1
    losses, params = _local(data, "b")
    np.testing.assert_allclose(g("losses"), losses, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(g("params"), params, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(g("losses"), jl, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(
        g("params"), np.concatenate([v.ravel() for v in jp.values()]),
        rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("tag", ["a", "b"])
def test_zero3_spmd_step_rests_as_its_rows(ranks, tag):
    """Between steps a ZeRO-3 ``SpmdTrainStep`` at dp 4 holds only this
    rank's rows of each dp-sharded param: a quarter of it, dim 0 padded
    as paddle_tpu pads it (the 7-13-5 net); stages 1 and 2 hold the
    params whole.  ``state_dict`` gives the model its full values first
    (the params the parity tests compare)."""
    _, data, res = ranks
    shapes = [data[k].shape for k in data
              if k.startswith(f"z{tag}.") and k[-2:] not in (".x", ".y")]
    padded = {int(k): v for k, v in json.loads(
        str(_get(res, f"zero/{tag}3.padded"))).items()}
    assert all(s == ["dp"] for s in json.loads(
        str(_get(res, f"zero/{tag}3.specs"))))
    full = sum(4 * int(np.prod(s)) for s in shapes)
    rows = sum(4 * (padded.get(i, [s[0], s[0]])[1] // DP)
               * int(np.prod(s[1:])) for i, s in enumerate(shapes))
    assert rows < full
    for r in range(DP):
        assert _get(res, f"zero/{tag}3.resident", r) == rows
        for stage in (1, 2):
            assert _get(res, f"zero/{tag}{stage}.resident", r) == full


def test_shard_and_gather_tree_roundtrip(ranks):
    """``test_shard_and_gather_tree_roundtrip``: each rank keeps its
    quarter of 'w' (spec ('dp',)), and ``gather_tree`` gives both
    leaves back exactly on every rank."""
    _, data, res = ranks
    for r in range(DP):
        np.testing.assert_array_equal(_get(res, "tree/w_local", r),
                                      data["tree_w"][4 * r:4 * r + 4])
        np.testing.assert_array_equal(_get(res, "tree/w_back", r),
                                      data["tree_w"])
        np.testing.assert_array_equal(_get(res, "tree/b_back", r),
                                      data["tree_b"])
    assert json.loads(str(_get(res, "tree/w_spec"))) == ["dp"]


def _restore_fc(cpu, ckpt, feed, steps=3):
    """This process (one rank, mesh {dp: 1}): the same ZeRO-3 fleet
    program, restored from the four ranks' snapshot, run on."""
    from paddle_tpu_torch.testing.sharding_cases import _fc_program
    from paddle_tpu_torch.utils import monitor
    from paddle_tpu_torch.utils.checkpoint import SnapshotStore
    cpu.enable_static()
    try:
        monitor.stat_reset()
        main, loss = _fc_program(zero3=True, seed=5, lr=0.05)
        exe = cpu.static.Executor()
        ss = exe.sharded_state(main)
        SnapshotStore(str(ckpt)).restore({"train": ss})
        params = np.concatenate([p.detach().numpy().ravel()
                                 for p in main.parameters()])
        cont = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                for _ in range(steps)]
        resharded = monitor.get_stat("sharding.restore.resharded") or 0
        exe.close()
        return params, cont, resharded, main._optimizer[0]._step_count
    finally:
        cpu.disable_static()


def test_zero3_executor_matches_plain_and_reshards_its_snapshot(ranks,
                                                                cpu):
    """``test_sharded_executor_matches_plain_and_never_recompiles`` and
    ``test_snapshot_store_reshard_roundtrip``: under ZeRO-3 at dp 4 the
    fc program's weight is dp-sharded, one build serves every run, and
    the losses are the program's without fleet (rtol 1e-5).  The
    snapshot carries a digest per file (the manifest and a block per
    rank); restored here on mesh {dp: 1} it gives the params bitwise,
    resharded, the step count, and the continuation within rtol 1e-5
    of the four ranks'."""
    out, data, res = ranks
    g = lambda k, r=0: _get(res, "snapshot/" + k, r)  # noqa: E731
    assert json.loads(str(g("specs")))[0] == ["dp"]
    assert g("compiles") == 1
    np.testing.assert_allclose(np.concatenate([g("losses"), g("cont")]),
                               g("plain"), rtol=1e-5)
    from paddle_tpu_torch.utils.checkpoint import SnapshotStore
    meta = SnapshotStore(str(out / "ckpt")).load_meta()
    digests = meta["snapshots"][-1]["digests"]
    assert "train.manifest.json" in digests
    assert sum(1 for k in digests if k.endswith(".shard")) >= DP
    feed = {"x": data["snap_x"], "y": data["snap_y"]}
    params, cont, resharded, step = _restore_fc(cpu, out / "ckpt", feed)
    np.testing.assert_array_equal(params, g("params"))
    assert resharded > 0 and step == 6
    np.testing.assert_allclose(cont, g("cont"), rtol=1e-5)


def test_corrupt_block_is_caught(ranks, cpu, tmp_path):
    """``test_snapshot_store_corrupt_shard_is_caught``: a flipped byte
    in one block fails its digest and the restore refuses to part-load
    (here on a copy of the four ranks' snapshot)."""
    import shutil
    from paddle_tpu_torch.utils.checkpoint import (CheckpointError,
                                                   SnapshotStore)
    out, _, _ = ranks
    ckpt = tmp_path / "ckpt"
    shutil.copytree(out / "ckpt", ckpt)
    sdir = ckpt / "epoch_0"
    victim = sorted(p for p in os.listdir(sdir) if p.endswith(".shard"))[0]
    raw = bytearray((sdir / victim).read_bytes())
    raw[-1] ^= 0xFF
    (sdir / victim).write_bytes(bytes(raw))
    with pytest.warns(UserWarning, match="sha256 mismatch"):
        with pytest.raises(CheckpointError):
            SnapshotStore(str(ckpt)).restore(
                {"train": tsh.ShardedState()})


def _local_sgd(data):
    """The Linear 8-8 of the grad_comm cases, 3 local SGD steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.jit import TrainStep
    net = nn.Linear(8, 8)
    net.set_state_dict({k: torch.from_numpy(data[f"gc.{k}"])
                        for k in net.state_dict()})
    opt = optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    step = TrainStep(net, lambda o, l: pt.nn.functional.mse_loss(o, l), opt)
    x, y = pt.to_tensor(data["gc.x"]), pt.to_tensor(data["gc.y"])
    for _ in range(3):
        step(x, y)
    return net.weight.detach().numpy()


def test_grad_comm_spmd_step_quantises_and_the_alias_is_bf16(ranks, cpu):
    """``test_grad_comm_spmd_int8_trains_close_to_fp32``,
    ``test_fp16_allreduce_quantises_grads`` and
    ``test_fp16_allreduce_alias_equals_grad_comm_bf16`` at dp 4: the int8
    and the bf16 wires change the weights (no silent no-op) and stay
    within rtol 3e-2 / atol 3e-3 of the fp32 step; some int8 bucket is
    on int8 wire; the alias trains bitwise as the explicit bf16."""
    _, data, res = ranks
    g = lambda k: _get(res, "zero/gc." + k)  # noqa: E731
    full = _local_sgd(data)
    for spelling in ("int8", "alias"):
        w = g(f"{spelling}.weight")
        np.testing.assert_allclose(w, full, rtol=3e-2, atol=3e-3)
        assert not np.array_equal(w, full), spelling
    assert "int8" in json.loads(str(g("int8.wires")))
    np.testing.assert_array_equal(g("alias.weight"), g("bf16.weight"))


def _fc_run(main, loss, exe, feed, n):
    return [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
            for _ in range(n)]


def test_sharded_state_survives_set_state_dict_interleaving(cpu, tmp_path):
    """``test_sharded_state_survives_set_state_dict_interleaving`` at one
    rank: a ``set_state_dict`` between runs keeps the slots visible to
    the sharded save (here they go straight into the live state), and a
    restore after it replays the uninterrupted continuation (rtol
    1e-6)."""
    from paddle_tpu_torch.testing.sharding_cases import _fc_program
    from paddle_tpu_torch.utils.checkpoint import SnapshotStore
    d = _snap_data()
    feed = {"x": d["snap_x"], "y": d["snap_y"]}
    cpu.enable_static()
    try:
        main, loss = _fc_program(seed=0, lr=0.05)
        exe = cpu.static.Executor()
        _fc_run(main, loss, exe, feed, 3)
        opt = main._optimizer[0]
        ckpt = opt.state_dict()
        assert ckpt["slots"]
        store = SnapshotStore(str(tmp_path / "ck"))
        store.save(0, {"train": exe.sharded_state(main)})
        ref = _fc_run(main, loss, exe, feed, 3)
        opt.set_state_dict(ckpt)
        got = exe.sharded_state(main)._getter()
        assert set(got.get("slots", {})) == {f"{int(k):04d}"
                                             for k in ckpt["slots"]}
        store.restore({"train": exe.sharded_state(main)})
        np.testing.assert_allclose(_fc_run(main, loss, exe, feed, 3), ref,
                                   rtol=1e-6)
        exe.close()
    finally:
        cpu.disable_static()


def test_restore_then_save_before_first_build_keeps_slots(cpu, tmp_path):
    """``test_restore_then_save_before_first_compile_keeps_slots`` at one
    rank: a fresh program restores a snapshot and saves it again before
    its first run; the second snapshot still carries every slot,
    bitwise."""
    from paddle_tpu_torch.testing.sharding_cases import _fc_program
    from paddle_tpu_torch.utils.checkpoint import SnapshotStore
    d = _snap_data()
    feed = {"x": d["snap_x"], "y": d["snap_y"]}
    cpu.enable_static()
    try:
        main, loss = _fc_program(seed=0)
        exe = cpu.static.Executor()
        _fc_run(main, loss, exe, feed, 3)
        ref = {k: {sk: np.asarray(sv).copy() for sk, sv in v.items()}
               for k, v in exe.sharded_state(main)._getter()["slots"]
               .items()}
        assert ref
        SnapshotStore(str(tmp_path / "ck1")).save(
            0, {"train": exe.sharded_state(main)})
        exe.close()
        main2, _ = _fc_program(seed=1)
        exe2 = cpu.static.Executor()
        SnapshotStore(str(tmp_path / "ck1")).restore(
            {"train": exe2.sharded_state(main2)})
        assert set(exe2.sharded_state(main2)._getter()["slots"]) == set(ref)
        SnapshotStore(str(tmp_path / "ck2")).save(
            0, {"train": exe2.sharded_state(main2)})
        main3, _ = _fc_program(seed=2)
        exe3 = cpu.static.Executor()
        ss3 = exe3.sharded_state(main3)
        SnapshotStore(str(tmp_path / "ck2")).restore({"train": ss3})
        got = ss3._getter()["slots"]
        assert set(got) == set(ref)
        for k, slots in ref.items():
            for sk, sv in slots.items():
                np.testing.assert_array_equal(np.asarray(got[k][sk]), sv)
    finally:
        cpu.disable_static()
