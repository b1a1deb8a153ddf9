"""``paddle_tpu_torch.distributed.fleet`` held to paddle_tpu's facade
(``tests/test_distributed.py::test_fleet_facade``, the pinned-mesh
cases, ``tests/test_strategy_toggles.py``'s fleet cases).

Each case runs in this process as a job of one rank over gloo (the
process group ``fleet.init`` joins is ended after the module); the same
calls run on paddle_tpu where it has them.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.core import placement


@pytest.fixture(scope="module", autouse=True)
def one_rank():
    prev = placement.default()
    pt.set_device("cpu")
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    dist.set_mesh(None)
    placement.set_default(prev)


def test_fleet_facade_on_both_packages():
    """``test_fleet_facade``: ``strategy.lamb`` swaps the optimizer for
    LAMB (``lars`` for LARS), one worker, ``distributed_model`` wraps
    the model in DataParallel whose output is the model's and whose
    ``scale_loss`` is the identity."""
    for pkg, pnn, popt, pdist in ((paddle, jnn, jopt, jdist),
                                  (pt, nn, optimizer, dist)):
        strat = pdist.DistributedStrategy()
        strat.lamb = True
        f = pdist.fleet
        f.init(is_collective=True, strategy=strat)
        assert f.worker_num() == 1 and f.worker_index() == 0
        assert f.is_first_worker() and f.is_worker()
        assert not f.is_server()
        net = pnn.Linear(4, 2)
        opt = f.distributed_optimizer(
            popt.Adam(0.01, parameters=net.parameters()))
        assert isinstance(opt, popt.Lamb)
        assert opt._dist_strategy is strat
        dp_model = f.distributed_model(net)
        x = pkg.randn([2, 4])
        out = dp_model(x)
        assert list(out.shape) == [2, 2]
        assert dp_model.scale_loss(out) is out
        s2 = pdist.DistributedStrategy()
        s2.lars = True
        f.init(is_collective=True, strategy=s2)
        assert isinstance(f.distributed_optimizer(
            popt.Momentum(0.1, parameters=net.parameters())),
            popt.LarsMomentum)
        assert f.util.get_file_shard(["a", "b", "c"]) == ["a", "b", "c"]
        f.barrier_worker()


def test_fleet_init_keeps_a_pinned_mesh():
    """``test_fleet_init_respects_pinned_subset_mesh``: a pinned mesh
    that carries the strategy's degrees survives ``fleet.init``; one
    whose degrees do not fit is rebuilt from the strategy."""
    pinned = dist.init_mesh({"dp": 1})
    dist.fleet.init(is_collective=True,
                    strategy=dist.DistributedStrategy())
    assert dist.get_mesh() is pinned
    s = dist.DistributedStrategy()
    s.tensor_parallel = True
    s.tensor_parallel_configs = {"tensor_parallel_degree": 1}
    dist.fleet.init(is_collective=True, strategy=s)
    assert dist.get_mesh() is pinned
    dist.init_mesh({"dp": 1, "mp": 1})
    dist.fleet.init(is_collective=True,
                    strategy=dist.DistributedStrategy())
    assert dict(dist.get_mesh().shape) == {"dp": 1, "mp": 1}


def test_distributed_optimizer_validates_the_strategy():
    """Degrees that do not divide the job, an unknown wire dtype, dgc,
    a_sync and the F-then-B schedule raise at ``distributed_optimizer``,
    as paddle_tpu's validation does; the toggles of slice A5b
    (pipeline, LocalSGD) pass it."""
    from paddle_tpu_torch.core.enforce import InvalidArgumentError
    net = nn.Linear(4, 2)
    f = dist.fleet
    s = dist.DistributedStrategy()
    s.tensor_parallel = True
    s.tensor_parallel_configs = {"tensor_parallel_degree": 3}
    f._strategy = s
    with pytest.raises(InvalidArgumentError, match="divide"):
        f.distributed_optimizer(optimizer.SGD(
            0.1, parameters=net.parameters()))
    for name, match in (("dgc", "dgc"), ("a_sync", "a_sync"),
                        ("pipeline", "F-then-B"), ("localsgd", None)):
        s = dist.DistributedStrategy()
        setattr(s, name, True)
        if name == "pipeline":
            s.pipeline_configs.schedule_mode = "F-then-B"
        if match is None:
            opt = f.distributed_optimizer(optimizer.SGD(
                0.1, parameters=net.parameters()), strategy=s)
            assert opt._dist_strategy is s
            continue
        with pytest.raises(NotImplementedError, match=match):
            f.distributed_optimizer(optimizer.SGD(
                0.1, parameters=net.parameters()), strategy=s)
        if name == "pipeline":
            s.pipeline_configs.schedule_mode = "1F1B"
            f.distributed_optimizer(optimizer.SGD(
                0.1, parameters=net.parameters()), strategy=s)
    s = dist.DistributedStrategy()
    s.grad_comm = {"dtype": "fp8"}
    with pytest.raises(InvalidArgumentError, match="wire dtype"):
        f.distributed_optimizer(optimizer.SGD(
            0.1, parameters=net.parameters()), strategy=s)


def test_get_train_step_and_localsgd_route():
    """``get_train_step`` builds the strategy's SpmdTrainStep (ZeRO-3 at
    one rank trains as the plain step); under ``strategy.localsgd`` it
    routes to LocalSGDTrainStep (``test_fleet_routes_localsgd``: the
    loss falls), and ``save_persistables`` writes the synced weights."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.parallel import SpmdTrainStep
    F = pt.nn.functional
    r = np.random.RandomState(19)
    x = pt.to_tensor(r.randn(16, 4).astype(np.float32))
    y = pt.to_tensor(r.randn(16, 3).astype(np.float32))
    pt.seed(19)
    net = nn.Linear(4, 3)
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    f = dist.Fleet()
    s = dist.DistributedStrategy()
    s.sharding = True
    s.sharding_configs = {"stage": 3, "min_shard_numel": 1}
    f.init(strategy=s)
    f.distributed_optimizer(optimizer.SGD(0.1,
                                          parameters=net.parameters()))
    step = f.get_train_step(net, lambda o, l: F.mse_loss(o, l))
    assert isinstance(step, SpmdTrainStep)
    got = [float(step(x, y)) for _ in range(3)]
    f.save_persistables()        # nothing to write without dirname
    net.set_state_dict(init)
    base = TrainStep(net, lambda o, l: F.mse_loss(o, l),
                     optimizer.SGD(0.1, parameters=net.parameters()))
    np.testing.assert_allclose(got, [float(base(x, y)) for _ in range(3)],
                               rtol=1e-6)
    s = dist.DistributedStrategy()
    s.localsgd = True
    f2 = dist.Fleet()
    f2.init(strategy=s)
    f2._optimizer = optimizer.SGD(0.1, parameters=net.parameters())
    from paddle_tpu_torch.parallel import LocalSGDTrainStep
    step = f2.get_train_step(net, lambda o, l: F.mse_loss(o, l))
    assert isinstance(step, LocalSGDTrainStep)
    l0, l1 = float(step(x, y)), float(step(x, y))
    assert l1 < l0
    f2.distributed_model(net)
    step._model_dirty = True
    seen = []
    orig = step.sync_to_model
    step.sync_to_model = lambda: (seen.append(1), orig())
    f2.save_persistables()
    assert seen == [1]


def test_fleet_save_inference_model_and_persistables(tmp_path):
    """``test_fleet_save_inference_model``: the registered model exported
    through ``jit.save`` loads and serves its own output (rtol 1e-5,
    atol 1e-6); ``save_persistables`` writes ``model.pdparams``; without
    a model the save names it (as paddle_tpu's)."""
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu.distributed.fleet import Fleet as JFleet
    f = dist.Fleet()
    f.init()
    pt.seed(37)
    net = nn.Linear(4, 3)
    f.distributed_model(net)
    path = f.save_inference_model(
        dirname=str(tmp_path), input_spec=[InputSpec([None, 4],
                                                      "float32")])
    x = np.random.RandomState(37).randn(5, 4).astype(np.float32)
    loaded = pt.jit.load(path)
    np.testing.assert_allclose(np.asarray(loaded(pt.to_tensor(x))),
                               net(pt.to_tensor(x)).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    f.save_persistables(dirname=str(tmp_path))
    assert os.path.exists(tmp_path / "model.pdparams")
    for F in (dist.Fleet, JFleet):
        with pytest.raises(ValueError, match="no model"):
            F().save_inference_model(dirname=str(tmp_path / "x"))


def test_static_minimize_through_fleet_runs_under_a_plan(tmp_path):
    """A static program minimized through ``fleet.distributed_optimizer``
    runs under the strategy's ShardingPlan: at one rank it trains as the
    program without fleet (rtol 1e-6), with the kernel tier off as
    paddle_tpu routes it under a plan, one build."""
    from paddle_tpu_torch.testing.sharding_cases import _fc_program
    rng = np.random.RandomState(1)
    xs = rng.standard_normal((64, 8)).astype(np.float32)
    feed = {"x": xs, "y": (xs @ rng.standard_normal((8, 1))).astype(
        np.float32)}
    pt.enable_static()
    try:
        losses = []
        for gc in ({"dtype": "int8"}, None):
            main, loss = _fc_program(gc, zero3=True, seed=3)
            if gc is None:
                main._optimizer[0]._dist_strategy = None
            exe = pt.static.Executor()
            losses.append([float(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0])
                           for _ in range(3)])
            assert exe.compile_count == 1
            (step,) = exe._cache.values()
            if gc is not None:
                plan = exe._plan_for(main, main.parameters())
                assert plan.grad_comm.dtype == "int8"
                assert step.kernels == [] and step.dist is None
            else:
                assert exe._plan_for(main, main.parameters()) is None
                assert step.kernels == ["fused_adam"]
            exe.close()
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    finally:
        pt.disable_static()


def test_fleet_util_and_save_persistables_over_two_ranks(tmp_path):
    """Two gloo ranks: ``fleet.util.all_reduce`` sums (max, min) the
    ranks' values and keeps a tensor a tensor, ``get_file_shard`` deals
    files by rank; after a ZeRO-3 ``get_train_step`` step the model's
    weight rests as the rank's rows, and ``save_persistables`` writes
    ``model.pdparams`` once, from rank 0, with the full values (those of
    the local step within 1e-6), which both ranks read back."""
    from paddle_tpu_torch.distributed.launch import spawn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.testing import sharding_cases
    r = np.random.RandomState(9)
    data = {"fleet.weight": r.standard_normal((4, 6)).astype(np.float32),
            "fleet.bias": r.standard_normal(6).astype(np.float32),
            "fleet.x": r.standard_normal((8, 4)).astype(np.float32),
            "fleet.y": r.standard_normal((8, 6)).astype(np.float32),
            "fleet_dir": np.asarray(str(tmp_path / "persist"))}
    os.makedirs(tmp_path / "persist")
    np.savez(tmp_path / "inputs.npz", **data)
    spawn(sharding_cases.run, (str(tmp_path), ["fleet"]), nprocs=2,
          init_method=f"file://{tmp_path}/store", timeout=120)
    res = [dict(np.load(tmp_path / f"rank{i}.npz")) for i in range(2)]
    net = nn.Linear(4, 6)
    net.set_state_dict({"weight": torch.from_numpy(data["fleet.weight"]),
                        "bias": torch.from_numpy(data["fleet.bias"])})
    step = TrainStep(net, lambda o, l: pt.nn.functional.mse_loss(o, l),
                     optimizer.SGD(learning_rate=0.1,
                                   parameters=net.parameters()))
    step(pt.to_tensor(data["fleet.x"]), pt.to_tensor(data["fleet.y"]))
    for rank, g in enumerate(res):
        np.testing.assert_array_equal(g["fleet/util.sum"], [2.0, 3.0])
        np.testing.assert_array_equal(g["fleet/util.max"], [1.0, 2.0])
        np.testing.assert_array_equal(g["fleet/util.min"], [1.0, 1.0])
        np.testing.assert_array_equal(g["fleet/util.tensor"], [1.0, 4.0])
        assert g["fleet/util.tensor_kind"] == 1
        assert json.loads(str(g["fleet/util.file_shard"])) == \
            list("abcde")[rank::2]
        assert json.loads(str(g["fleet/resting_shape"])) == [2, 6]
        assert g["fleet/writes"] == (1 if rank == 0 else 0)
        np.testing.assert_allclose(g["fleet/saved.weight"],
                                   net.weight.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(g["fleet/saved.bias"],
                                   net.bias.detach().numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        dist.fleet.util.all_reduce(np.ones(2), "mean")
