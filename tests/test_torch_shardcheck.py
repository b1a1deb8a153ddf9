"""Shardcheck held to paddle_tpu (the twins of the shardcheck cases of
``tests/test_static_analysis.py``).

Each case records the same fleet fc program in both packages and runs
the static analysis on the same mesh shape: paddle_tpu on conftest's
virtual devices, the port on a ``distributed.mesh.Mesh`` of that shape
(shardcheck needs no devices and no process
group: the port's plan is made on an ``AbstractMesh`` of the shape).
The diagnostics must carry the same codes (pass, severity) and
paddle_tpu's cause strings word for word; where the port's Executor
refuses the config before it needs the other ranks (a pp axis under
grad_comm, a sum-reduced loss, the ``FLAGS_shard_verify`` preflight)
its runtime raise carries the static message too.  The runtime halves
that need the ranks (the hybrid and ZeRO-3 steps) run in the gloo
worlds of ``test_torch_pipeline_parallel.py`` and
``test_torch_grad_comm.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import distributed as jdist, optimizer as joptimizer
from paddle_tpu.core.enforce import GraphVerificationError as JGVE
from paddle_tpu.static import analysis as janalysis

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import distributed as tdist, optimizer as toptimizer
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.core.enforce import GraphVerificationError as TGVE
from paddle_tpu_torch.static import analysis as tanalysis


@pytest.fixture(scope="module", autouse=True)
def one_rank():
    """``fleet.init`` in this process joins a one-rank gloo job: end it,
    the mesh and the default device after the module."""
    prev = placement.default()
    tpaddle.set_device("cpu")
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    tdist.set_mesh(None)
    placement.set_default(prev)


@pytest.fixture(autouse=True)
def static_mode():
    jpaddle.enable_static()
    tpaddle.enable_static()
    yield
    jpaddle.disable_static()
    tpaddle.disable_static()
    jpaddle.static.reset_default_programs()
    tpaddle.static.reset_default_programs()


def _program(pkg, F, dist, opt_mod, gc, zero3, reduction):
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [None, 8], "float32")
        y = pkg.static.data("y", [None, 1], "float32")
        loss = F.mse_loss(pkg.static.nn.fc(x, 1), y, reduction=reduction)
        s = dist.DistributedStrategy()
        if gc is not None:
            s.grad_comm = gc
        if zero3:
            s.sharding = True
            s.sharding_configs = {"stage": 3, "min_shard_numel": 1}
        dist.fleet.init(is_collective=True, strategy=s)
        opt = dist.fleet.distributed_optimizer(
            opt_mod.Adam(learning_rate=1e-2))
        opt.minimize(loss)
    return main, loss


def _both(gc=None, zero3=False, reduction="mean", mesh_shape={"dp": 8}):
    """The program on each side with its Executor's plan on the mesh."""
    jdist.init_mesh(mesh_shape)
    jmain, jloss = _program(jpaddle, JF, jdist, joptimizer, gc, zero3,
                            reduction)
    jdist.init_mesh(mesh_shape)
    jexe = jpaddle.static.Executor()
    jplan = jexe._plan_for(jmain, jmain.parameters())
    tmain, tloss = _program(tpaddle, TF, tdist, toptimizer, gc, zero3,
                            reduction)
    # a mesh of the shape alone: the one rank here has no groups for it
    tdist.set_mesh(tanalysis.AbstractMesh(mesh_shape))
    texe = tpaddle.static.Executor()
    tplan = texe._plan_for(tmain, tmain.parameters())
    return ((jmain, jloss, jexe, jplan), (tmain, tloss, texe, tplan))


def _diags(analysis, main, loss, plan):
    return analysis.check(main, fetch_list=[loss], sharding=plan)


def _codes(diags):
    return sorted((d.pass_name, d.severity) for d in diags
                  if d.pass_name.startswith("shard-"))


def _errors(diags):
    return [d for d in diags if d.severity == "error"
            and d.pass_name.startswith("shard-")]


def _fc_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.standard_normal((64, 8)).astype(np.float32),
            "y": rng.standard_normal((64, 1)).astype(np.float32)}


def test_zero3_grad_comm_static_and_runtime_both_accept():
    """ZeRO-3 + int8 grad_comm lints clean with a wire audit over the
    reduce-scatter route and the gather choreography; same codes, same
    messages on both sides."""
    (jm, jl, _, jp), (tm, tl, _, tp) = _both({"dtype": "int8"}, zero3=True)
    jd, td = _diags(janalysis, jm, jl, jp), _diags(tanalysis, tm, tl, tp)
    assert _errors(td) == [] and _errors(jd) == []
    assert _codes(td) == _codes(jd)
    audits = [d for d in td if d.pass_name == "shard-wire"
              and d.severity == "info"]
    assert len(audits) == 1 and "gather(s)" in audits[0].message
    chor = [d.message for d in td if d.pass_name == "shard-choreography"
            and d.severity == "info"]
    assert any("rscatter" in m for m in chor)
    assert any("hybrid choreography" in m for m in chor)
    jchor = [d.message for d in jd if d.pass_name == "shard-choreography"
             and d.severity == "info" and "overlap=" not in d.message]
    assert [m for m in chor if "overlap=" not in m] == jchor
    assert [d.message for d in audits] == [
        d.message for d in jd if d.pass_name == "shard-wire"]


def test_non_pure_dp_mesh_static_matches_runtime_cause():
    """A pp axis under grad_comm: one error on each side, the same
    string, naming ``pp=2`` and the cross-stage constraint, and the
    port's Executor raises exactly that string."""
    (jm, jl, _, jp), (tm, tl, texe, tp) = _both(
        {"dtype": "int8"}, mesh_shape={"dp": 4, "pp": 2})
    je, te = _errors(_diags(janalysis, jm, jl, jp)), \
        _errors(_diags(tanalysis, tm, tl, tp))
    assert len(te) == 1 and len(je) == 1
    assert te[0].message == je[0].message
    assert "pp=2" in te[0].message and "cross-stage" in te[0].message
    with pytest.raises(NotImplementedError) as ei:
        texe.run(tm, feed=_fc_feed(), fetch_list=[tl])
    assert str(ei.value) == te[0].message
    texe.close()


def test_hybrid_mesh_static_and_runtime_both_accept():
    """The static half: {dp: 4, mp: 2} lints clean on both sides with
    the same diagnostics (the runtime half runs in the pipeline module's
    gloo world)."""
    (jm, jl, _, jp), (tm, tl, _, tp) = _both(
        {"dtype": "int8"}, mesh_shape={"dp": 4, "mp": 2})
    jd, td = _diags(janalysis, jm, jl, jp), _diags(tanalysis, tm, tl, tp)
    assert _errors(td) == [] == _errors(jd)
    assert _codes(td) == _codes(jd)


def test_sum_fetch_static_matches_runtime_cause():
    (jm, jl, _, jp), (tm, tl, texe, tp) = _both({"dtype": "int8"},
                                                reduction="sum")
    je, te = _errors(_diags(janalysis, jm, jl, jp)), \
        _errors(_diags(tanalysis, tm, tl, tp))
    assert len(te) == 1 and "SUM-reduced" in te[0].message
    # the loss's name is each process's own Variable counter
    assert te[0].message.replace(tl.name, "<loss>") == \
        je[0].message.replace(jl.name, "<loss>")
    with pytest.raises(NotImplementedError) as ei:
        texe.run(tm, feed=_fc_feed(), fetch_list=[tl])
    assert str(ei.value) == te[0].message
    texe.close()


def test_overlap_note_matches_cost_model():
    """The overlap INFO and ``cost._comm_block`` resolve the knob
    identically (auto -> 'xla', ring stays 'ring') on both sides."""
    from paddle_tpu.static.analysis.cost import _comm_block as jcb
    from paddle_tpu_torch.static.analysis.cost import _comm_block as tcb
    for overlap, path in (("auto", "xla"), ("ring", "ring")):
        (jm, jl, _, jp), (tm, tl, _, tp) = _both(
            {"dtype": "int8", "overlap": overlap})
        for analysis, cb, m, lo, p in ((janalysis, jcb, jm, jl, jp),
                                       (tanalysis, tcb, tm, tl, tp)):
            notes = [d for d in _diags(analysis, m, lo, p)
                     if d.pass_name == "shard-choreography"
                     and d.severity == "info" and "overlap=" in d.message]
            assert len(notes) == 1
            assert cb(m, p)["overlap_path"] == path
            assert f"'{path}'" in notes[0].message or \
                f"overlap={overlap!r} lowers as requested" in \
                notes[0].message


def test_shard_verify_preflight_flag():
    """``FLAGS_shard_verify``: the pp-axis config fails the preflight as
    a GraphVerificationError carrying the runtime cause on both sides;
    with the flag off the same config reaches the runtime raise."""
    (jm, jl, jexe, _), (tm, tl, texe, _) = _both(
        {"dtype": "int8"}, mesh_shape={"dp": 4, "pp": 2})
    for pkg, exe, m, lo, gve in ((jpaddle, jexe, jm, jl, JGVE),
                                 (tpaddle, texe, tm, tl, TGVE)):
        pkg.set_flags({"FLAGS_shard_verify": True})
        try:
            with pytest.raises(gve, match="cross-stage"):
                exe.run(m, feed=_fc_feed(), fetch_list=[lo])
        finally:
            pkg.set_flags({"FLAGS_shard_verify": False})
        with pytest.raises(NotImplementedError, match="cross-stage"):
            exe.run(m, feed=_fc_feed(), fetch_list=[lo])
        exe.close()


def _lint_program(pkg, F, opt_mod):
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [8, 16], "float32")
        y = pkg.static.data("y", [8, 1], "float32")
        loss = F.mse_loss(pkg.static.nn.fc(x, 1), y)
        opt_mod.Adam(learning_rate=1e-2).minimize(loss)
    return main, loss


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_abstract_mesh_lint_zero_devices(side):
    """No mesh at all: {dp: 4, pp: 2} lints to the cross-stage error,
    {dp: 4, mp: 2} lints clean, and a rule that divides no dim is a
    warning naming the rule and the axis."""
    if side == "jax":
        pkg, F, dist, opt_mod, analysis = (jpaddle, JF, jdist, joptimizer,
                                           janalysis)
    else:
        pkg, F, dist, opt_mod, analysis = (tpaddle, TF, tdist, toptimizer,
                                           tanalysis)
    assert analysis.parse_mesh_shape("dp=4,mp=2") == {"dp": 4, "mp": 2}
    assert analysis.parse_mesh_shape("8") == {"dp": 8}
    with pytest.raises(ValueError, match="axis=size"):
        analysis.parse_mesh_shape("dp:4")
    main, loss = _lint_program(pkg, F, opt_mod)
    strat = dist.DistributedStrategy()
    strat.grad_comm = {"dtype": "int8"}
    diags = analysis.check(main, fetch_list=[loss],
                           mesh_shape={"dp": 4, "pp": 2}, strategy=strat)
    msgs = [d.message for d in diags
            if d.pass_name == "shard-choreography" and d.severity == "error"]
    assert len(msgs) == 1 and "cross-stage" in msgs[0] and "pp=2" in msgs[0]
    diags = analysis.check(main, fetch_list=[loss],
                           mesh_shape={"dp": 4, "mp": 2}, strategy=strat)
    assert [d for d in diags if d.severity == "error"] == []
    wname = next(p.name for p in main.parameters()
                 if tuple(p.shape) == (16, 1))
    diags = analysis.check(
        main, fetch_list=[loss], mesh_shape={"dp": 2, "mp": 3},
        sharding_rules=[(wname, (None, "mp")), (r".*", ())])
    warns = [d for d in diags if d.pass_name == "shard-plan"
             and d.severity == "warning"]
    assert len(warns) == 1
    assert "mesh axis 'mp' (size 3)" in warns[0].message
    assert f"rule r'{wname}'" in warns[0].message


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_taint_pass_flags_device_varying_fetch_and_resync(side):
    pkg, analysis = ((jpaddle, janalysis) if side == "jax"
                     else (tpaddle, tanalysis))
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [8, 4], "float32")
        y = x * 2.0
        if side == "jax":
            idx = main.record(lambda a: a, [y], {}, "axis_index")
            synced = main.record(lambda a: a, [idx], {}, "all_reduce")
        else:       # the port's record takes (fn, inputs, op_name, attrs)
            idx = main.record(lambda a: a, [y], "axis_index", {})
            synced = main.record(lambda a: a, [idx], "all_reduce", {})
    plan = analysis.AbstractPlan(analysis.AbstractMesh({"dp": 4}), [], [])
    taint = analysis.DeviceVaryingTaintPass(plan)
    diags = analysis.check(main, fetch_list=[idx], passes=[taint])
    assert [d.severity for d in diags] == ["error"]
    assert "axis_index" in diags[0].message
    assert analysis.check(main, fetch_list=[synced], passes=[taint]) == []


def test_mesh_axis_formatter_is_shared():
    """One formatter renders axis=degree in the mesh-constraint messages
    of both packages."""
    from paddle_tpu.distributed import grad_comm as jgc
    from paddle_tpu_torch.distributed import grad_comm as tgc
    for gc in (jgc, tgc):
        assert gc.format_mesh_axes({"dp": 8, "mp": 2, "pp": 4},
                                   exclude=("dp",)) == "mp=2, pp=4"
        assert gc.format_mesh_axes({"dp": 8}) == "dp=8"
        assert gc.format_mesh_axes({"dp": 8, "mp": 1},
                                   exclude=("dp",)) == ""
    js, ts = jdist.DistributedStrategy(), tdist.DistributedStrategy()
    js.grad_comm = ts.grad_comm = {"dtype": "bf16"}
    msg = tgc.incompatibility(tgc.resolve(ts), {"dp": 4, "pp": 2})
    assert "pp=2" in msg
    assert msg == jgc.incompatibility(jgc.resolve(js), {"dp": 4, "pp": 2})


def test_wire_audit_equals_the_cost_models_prediction():
    """The audit's independent wire bytes equal ``analyze(sharding=)``'s
    prediction and the plan's schedule (the third leg of measured ==
    predicted), on {dp: 4, mp: 2} with ZeRO-3 and int8."""
    from paddle_tpu_torch.static.analysis.shardcheck import (
        _derive_gplan, audit_wire_bytes)
    _, (tm, tl, _, tp) = _both({"dtype": "int8"}, zero3=True,
                               mesh_shape={"dp": 4, "mp": 2})
    audit = audit_wire_bytes(_derive_gplan(tm, tp))
    rep = tm.analyze(fetch_list=[tl], sharding=tp, batch_size=64)
    comm = rep.totals["comm"]
    assert comm["wire_bytes_per_step"] == audit["wire_bytes_per_step"]
    assert comm["collectives_per_step"] == audit["collectives_per_step"]
