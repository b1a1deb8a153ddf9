"""The strategy toggles held to ``tests/test_strategy_toggles.py``:
``sharding``, ``fp16_allreduce`` and ``grad_comm`` work or raise
paddle_tpu's errors; the knobs validate as paddle_tpu's; gradient
merge, recompute, amp, pipeline and LocalSGD (slice A5b) run, each
where paddle_tpu wires it; dgc and a_sync raise for good.  The multi-rank numerics of these toggles are asserted on gloo
ranks in ``tests/test_torch_sharding.py`` and
``tests/test_torch_grad_comm.py``; here each case runs at one rank or
with a stand-in mesh, on both packages where paddle_tpu has the case.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.core.enforce import InvalidArgumentError as JErr
from paddle_tpu.distributed.strategy import DistributedStrategy as JS
from paddle_tpu.distributed.strategy import validate_toggles as jvalidate
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.core.enforce import InvalidArgumentError as TErr
from paddle_tpu_torch.distributed.strategy import DistributedStrategy as TS
from paddle_tpu_torch.distributed.strategy import validate_toggles
from paddle_tpu_torch.parallel import SpmdTrainStep


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    pt.set_device("cpu")
    dist.set_mesh(None)
    yield pt
    dist.set_mesh(None)
    placement.set_default(prev)


def _toy(seed=7, din=4, dout=3, bs=16):
    pt.seed(seed)
    net = pt.nn.Linear(din, dout)
    r = np.random.RandomState(seed)
    x = pt.to_tensor(r.randn(bs, din).astype(np.float32))
    y = pt.to_tensor(r.randn(bs, dout).astype(np.float32))
    return net, x, y, lambda o, l: pt.nn.functional.mse_loss(o, l)


def _both(setup):
    """Run ``setup`` on a fresh strategy of each package."""
    out = []
    for S in (JS, TS):
        s = S()
        setup(s)
        out.append(s)
    return out


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return types.SimpleNamespace(shape=dict(shape), size=n,
                                 ranks=np.arange(n),
                                 line=lambda a: [0], group=lambda a: None)


def test_fuse_grad_size_rejects_nonsense():
    """``test_fuse_grad_size_rejects_nonsense``: 0, -3 and 0.0 raise
    paddle_tpu's InvalidArgumentError text; 16 passes."""
    for bad in (0, -3, 0.0):
        j, t = _both(lambda s: setattr(s, "fuse_grad_size_in_MB", bad))
        with pytest.raises(JErr) as je:
            jvalidate(j)
        with pytest.raises(TErr) as te:
            validate_toggles(t)
        assert str(te.value) == str(je.value)
    s = TS()
    s.fuse_grad_size_in_MB = 16
    validate_toggles(s)


@pytest.mark.parametrize("knobs,match", [
    ({"dtype": "fp8"}, "wire dtype"),
    ({"dtype": "int8", "block_size": 0}, "block"),
    ({"dtype": "int8", "scatter_threshold_KB": -1}, "scatter_threshold"),
    ({"dtype": "int8", "overlap": "eager"}, "overlap"),
])
def test_grad_comm_knob_validation(knobs, match):
    """``test_grad_comm_knob_validation`` and
    ``test_grad_comm_overlap_knob_validation``: each bad knob raises the
    same InvalidArgumentError on both packages."""
    j, t = _both(lambda s: setattr(s, "grad_comm", knobs))
    with pytest.raises(JErr, match=match):
        jvalidate(j)
    with pytest.raises(TErr, match=match) as te:
        validate_toggles(t)
    assert match in str(te.value)


def test_grad_comm_valid_knobs_and_the_alias():
    """Every wire dtype and overlap mode validates; the fp16_allreduce
    alias conflicts with an explicit non-bf16 dtype (paddle_tpu's
    text) and resolves to a bf16 wire without error feedback; the
    overlap knob rides the spec's fingerprint."""
    from paddle_tpu_torch.distributed import grad_comm as tgc
    for d in (None, "fp32", "bf16", "int8"):
        for ov in ("none", "auto", "ring"):
            s = TS()
            s.grad_comm = {"dtype": d, "overlap": ov}
            validate_toggles(s)
    j, t = _both(lambda s: (setattr(s, "fp16_allreduce", True),
                            setattr(s, "grad_comm", {"dtype": "int8"})))
    with pytest.raises(JErr) as je:
        jvalidate(j)
    with pytest.raises(TErr) as te:
        validate_toggles(t)
    assert str(te.value) == str(je.value) and "alias" in str(te.value)
    s = TS()
    s.fp16_allreduce = True
    cfg = tgc.resolve(s)
    assert (cfg.dtype, cfg.error_feedback, cfg.source) == (
        "bf16", False, "fp16_allreduce")
    assert tgc.resolve(TS()) is None


def test_grad_comm_hybrid_degree_combos_validate():
    """``test_grad_comm_hybrid_degree_combos_validate``: ZeRO-3 + mp +
    grad_comm validates and composes {dp: 4, mp: 2} on 8 devices; pp
    and sp raise naming the toggle (the alias too, 'cross-stage');
    without grad_comm the pp strategy validates and shapes the mesh."""
    s = TS()
    s.grad_comm = {"dtype": "int8"}
    s.sharding = True
    s.sharding_configs = {"stage": 3, "min_shard_numel": 1}
    s.tensor_parallel = True
    s.tensor_parallel_configs = {"tensor_parallel_degree": 2}
    validate_toggles(s, n_devices=8)
    assert s.infer_mesh_shape(8) == {"dp": 4, "mp": 2}
    for toggle in ("pipeline", "sequence_parallel"):
        s = TS()
        s.grad_comm = {"dtype": "bf16"}
        setattr(s, toggle, True)
        with pytest.raises(NotImplementedError, match=toggle):
            validate_toggles(s)
    s = TS()
    s.fp16_allreduce = True
    s.pipeline = True
    with pytest.raises(NotImplementedError, match="cross-stage"):
        validate_toggles(s)
    s = TS()
    s.pipeline = True
    s.pipeline_configs = {"pp_degree": 2}
    validate_toggles(s, n_devices=8)
    assert s.infer_mesh_shape(8) == {"pp": 2, "dp": 4}


@pytest.mark.parametrize("name", ["gradient_merge", "recompute", "amp",
                                  "pipeline", "localsgd",
                                  "adaptive_localsgd"])
def test_toggles_of_the_next_slice_raise_naming_it(name):
    """The strategy machinery of slice A5b, which raised naming it,
    now runs, never a silent no-op: each toggle validates and takes
    effect where paddle_tpu wires it (SpmdTrainStep's accumulation,
    recompute and autocast; the pipeline's mesh axis; fleet's LocalSGD
    route, whose step at one rank trains as the plain step)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.parallel import LocalSGDTrainStep
    s = TS()
    setattr(s, name, True)
    validate_toggles(s)
    net, x, y, loss_fn = _toy()
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    opt = pt.optimizer.SGD(0.1, parameters=net.parameters())
    if name == "pipeline":
        s.pipeline_configs = {"pp_degree": 4}
        assert s.infer_mesh_shape(8) == {"pp": 4, "dp": 2}
        return
    if name in ("localsgd", "adaptive_localsgd"):
        f = dist.Fleet()
        f.init(strategy=s)
        f.distributed_optimizer(opt)
        step = f.get_train_step(net, loss_fn)
        assert isinstance(step, LocalSGDTrainStep)
        assert step.adaptive == (name == "adaptive_localsgd")
    else:
        if name == "gradient_merge":
            s.gradient_merge_configs = {"k_steps": 2}
        step = SpmdTrainStep(net, loss_fn, opt, strategy=s)
        assert {"gradient_merge": step.accumulate_steps == 2,
                "recompute": step._recompute,
                "amp": step.amp_level == "O1"
                and net._amp_dtype == "bfloat16"}[name]
    got = [float(step(x, y)) for _ in range(3)]
    net.set_state_dict(init)
    base = TrainStep(net, loss_fn, pt.optimizer.SGD(
        0.1, parameters=net.parameters()),
        accumulate_steps=2 if name == "gradient_merge" else 1)
    want = [float(base(x, y)) for _ in range(3)]
    # bf16 autocast rounds the matmuls (3 decimal digits): close to the
    # f32 step's losses, and not equal to them
    np.testing.assert_allclose(got, want,
                               rtol=2e-2 if name == "amp" else 1e-6)
    assert (got != want) == (name == "amp")


@pytest.mark.parametrize("name", ["dgc", "a_sync"])
def test_dgc_and_a_sync_raise(name):
    """``test_dgc_raises`` / ``test_a_sync_raises``: SpmdTrainStep and
    fleet refuse them, as paddle_tpu does."""
    net, x, y, loss_fn = _toy()
    s = TS()
    setattr(s, name, True)
    opt = pt.optimizer.SGD(0.1, parameters=net.parameters())
    with pytest.raises(NotImplementedError, match=name):
        SpmdTrainStep(net, loss_fn, opt, strategy=s)
    with pytest.raises(NotImplementedError, match=name):
        validate_toggles(s)


def test_grad_comm_rejects_model_sharded_meshes():
    """``test_grad_comm_rejects_model_sharded_mesh``,
    ``test_fp16_allreduce_rejects_model_sharding`` and
    ``test_fp16_allreduce_zero3_still_raises``: the SpmdTrainStep's
    explicit dp reduction refuses an 'mp' axis and ZeRO-3 params with
    paddle_tpu's messages."""
    from paddle_tpu.distributed import grad_comm as jgc
    from paddle_tpu_torch.distributed import grad_comm as tgc
    net, x, y, loss_fn = _toy()
    for knobs, match in (({"grad_comm": {"dtype": "int8",
                                         "error_feedback": False}},
                          "grad_comm"),
                         ({"fp16_allreduce": True}, "fp16_allreduce")):
        s = TS()
        for k, v in knobs.items():
            setattr(s, k, v)
        opt = pt.optimizer.SGD(0.1, parameters=net.parameters())
        with pytest.raises(NotImplementedError, match=match) as e:
            SpmdTrainStep(net, loss_fn, opt, strategy=s,
                          mesh=_mesh({"dp": 4, "mp": 2}))
        js = JS()
        for k, v in knobs.items():
            setattr(js, k, v)
        assert str(e.value) == jgc.incompatibility(
            jgc.resolve(js), {"dp": 4, "mp": 2})
    s = TS()
    s.fp16_allreduce = True
    s.sharding = True
    s.sharding_configs = {"stage": 3, "min_shard_numel": 1}
    opt = pt.optimizer.SGD(0.1, parameters=net.parameters())
    with pytest.raises(NotImplementedError, match="fp16_allreduce"):
        SpmdTrainStep(net, loss_fn, opt, strategy=s)
    assert tgc.incompatibility(tgc.resolve(s), {"dp": 8},
                               ["<ZeRO-3 stage-3 params>"]) is not None


def test_zero3_honors_an_external_load():
    """``test_zero3_padded_honors_external_load``: a weight assigned
    between steps is what the next ZeRO-3 step trains from (the port
    keeps full parameters between steps), one SGD step away."""
    pt.seed(43)
    net = pt.nn.Linear(7, 5)
    r = np.random.RandomState(43)
    x = pt.to_tensor(r.randn(16, 7).astype(np.float32))
    y = pt.to_tensor(r.randn(16, 5).astype(np.float32))
    s = TS()
    s.sharding = True
    s.sharding_configs = {"stage": 3, "min_shard_numel": 1}
    opt = pt.optimizer.SGD(0.1, parameters=net.parameters())
    step = SpmdTrainStep(net, lambda o, l: pt.nn.functional.mse_loss(o, l),
                         opt, strategy=s)
    step(x, y)
    w_new = r.randn(7, 5).astype(np.float32)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(w_new))
    b = net.bias.detach().numpy().copy()
    step(x, y)
    step.sync_params()
    xn, yn = x.numpy(), y.numpy()
    grad = 2.0 / yn.size * xn.T @ (xn @ w_new + b - yn)
    np.testing.assert_allclose(net.weight.detach().numpy(),
                               w_new - 0.1 * grad, rtol=1e-5, atol=1e-6)
