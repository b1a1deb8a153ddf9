"""paddle_tpu_torch's static analysis held to paddle_tpu's.

The cases of ``tests/test_analysis_cost.py`` (cost model, liveness,
fusion candidates, roofline, report, anchors, hazards, the Executor's
prediction) and ``tests/test_static_analysis.py`` (the def-use graph,
the verifier passes, ``FLAGS_static_verify``, the Executor's versions),
each run on the port and, where the program records in both packages,
on paddle_tpu beside it:

- the same program, recorded by both, gives the same FLOPs per op and in
  total (``flops_fwd``, ``flops_train``, ``optimizer_flops``) on the
  bench's static MLP, LeNet, BERT and GPT at their CPU configs, the
  same fusion candidates with the same ``realized`` labels, and the same
  memory figures but for one kept difference, asserted: the port's
  integers stay int64, where paddle_tpu's op outputs run as int32, so
  the labels' reshape is 4 bytes an element more here;
- a broken program gives the same diagnostic codes and severities, and
  ``verify`` raises on the same ones;
- kept differences, each asserted: the chip rows are ``cpu`` and
  ``h100`` (a TPU name raises the same KeyError), float64 stays float64
  on the card (its output is flagged too), and int64 draws no info.
"""
import importlib.util
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import dispatch as jdispatch
from paddle_tpu.core.enforce import GraphVerificationError as JGVE
from paddle_tpu.static import analysis as janalysis
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import dispatch as tdispatch
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.core.enforce import GraphVerificationError as TGVE
from paddle_tpu_torch.core.flags import set_flags as tset_flags
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.static import analysis as tanalysis
from paddle_tpu_torch.testing import models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.basename(__file__)

JAX = types.SimpleNamespace(
    name="jax", pk=paddle, static=paddle.static, nn=jnn, F=JF, opt=jopt,
    analysis=janalysis, GVE=JGVE, apply=jdispatch.apply,
    set_flags=paddle.set_flags, seed=paddle.seed,
    zeros=lambda shape: jnp.zeros(shape, jnp.float32))
PORT = types.SimpleNamespace(
    name="port", pk=pt, static=pt.static, nn=tnn, F=TF, opt=topt,
    analysis=tanalysis, GVE=TGVE, apply=tdispatch.apply,
    set_flags=tset_flags, seed=pt.seed,
    zeros=lambda shape: torch.zeros(shape))
SIDES = (JAX, PORT)


@pytest.fixture(autouse=True)
def static_both():
    prev = placement.default()
    pt.set_device("cpu")
    pt.enable_static()
    paddle.enable_static()
    # the JAX kernel tier selects on the CPU only in interpret mode, as
    # paddle_tpu's own Executor tests run it
    paddle.set_flags({"pallas_interpret": True})
    yield
    paddle.set_flags({"pallas_interpret": False})
    for s in SIDES:
        s.set_flags({"FLAGS_static_verify": False,
                     "FLAGS_static_anchors": False})
    tset_flags({"use_pallas_kernels": True})
    pt.disable_static()
    paddle.disable_static()
    paddle.static.reset_default_programs()
    pt.static.reset_default_programs()
    placement.set_default(prev)


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mlp(s, hidden=8, depth=2, with_opt=True):
    """test_analysis_cost.py's ``_mlp_program`` on side ``s``."""
    main = s.static.Program()
    with s.static.program_guard(main):
        x = s.static.data("x", [None, hidden], "float32")
        y = s.static.data("y", [None, 1], "float32")
        h = x
        for _ in range(depth):
            h = s.static.nn.fc(h, hidden, activation="relu")
        loss = s.F.mse_loss(s.static.nn.fc(h, 1), y)
        if with_opt:
            s.opt.Adam(learning_rate=1e-3).minimize(loss)
    return main, loss


def _codes(diags):
    return [(d.pass_name, d.severity) for d in diags]


# ------------------------------------------- the bench's four programs --
def _jax_static_mlp():
    """bench_static's ``build_mlp`` at its CPU config (bench.py:638)."""
    paddle.seed(7)
    main, loss = _mlp(JAX, hidden=128, depth=8)
    return main, loss


def _jax_static_lenet():
    paddle.seed(9)
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [None, 1, 28, 28], "float32")
        y = paddle.static.data("y", [None], "int64")
        loss = JF.cross_entropy(JLeNet()(x), y)
        jopt.Adam(learning_rate=1e-3).minimize(loss)
    return main, loss


BERT = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512, seq=128,
            batch=8)
GPT = dict(BERT, batch=4)
PROGRAMS = {
    "mlp": (_jax_static_mlp, lambda: models.build_static_mlp(128, 8), 32),
    "lenet": (_jax_static_lenet, models.build_static_lenet, 16),
    "bert": (lambda: _bench().build_bert_static(**BERT)[:2],
             lambda: models.build_bert_static(**BERT)[:2], None),
    "gpt": (lambda: _bench().build_gpt_static(**GPT)[:2],
            lambda: models.build_gpt_static(**GPT)[:2], None),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_bench_programs_cost_as_paddle_tpu_does(name):
    jbuild, tbuild, bs = PROGRAMS[name]
    (jm, jl), (tm, tl) = jbuild(), tbuild()
    j = jm.analyze(fetch_list=[jl], batch_size=bs, top_k=None)
    t = tm.analyze(fetch_list=[tl], batch_size=bs, top_k=None)
    assert [(c.op_name, c.rule, c.flops, c.param_bytes) for c in t.per_op] \
        == [(c.op_name, c.rule, c.flops, c.param_bytes) for c in j.per_op]
    for k in ("flops_fwd", "flops_train", "optimizer_flops", "feed_bytes",
              "fetch_bytes", "param_bytes"):
        assert t.totals[k] == j.totals[k], k
    assert t.totals["flops_train"] > 3 * t.totals["flops_fwd"] > 0
    assert t.totals["unmodeled"] == j.totals["unmodeled"]
    assert t.totals["unmodeled"]["count"] == 0
    # the kept difference: int64 op outputs (the labels' reshape) are 8
    # bytes an element here, 4 in paddle_tpu
    extra = sum(v.meta.numel() * 4 for n in tm.nodes for v in n.out_vars
                if v.meta.dtype == torch.int64)
    assert extra == (0 if name in ("mlp", "lenet")
                     else BERT["seq"] * (BERT if name == "bert"
                                         else GPT)["batch"] * 4)
    tmem, jmem = t.memory.to_dict(), j.memory.to_dict()
    for k in ("retained_activation_bytes", "peak_bytes_donated",
              "peak_bytes_no_donation"):
        assert tmem[k] - jmem[k] == extra, k
    for k in ("feed_bytes", "param_bytes", "trainable_param_bytes",
              "grad_bytes", "slot_bytes", "slots_estimated", "training"):
        assert tmem[k] == jmem[k], k
    assert t.totals["min_traffic_bytes"] - j.totals["min_traffic_bytes"] \
        == 2 * extra
    assert (t.totals["unfused_traffic_bytes"]
            - j.totals["unfused_traffic_bytes"]) == 2 * extra
    cand = lambda c: (c["ops"], c["op_names"], c["saved_bytes"],  # noqa
                      c["flops"], c["realized"], c["realized_ops"])
    assert [cand(c) for c in t.fusion_candidates] \
        == [cand(c) for c in j.fusion_candidates]
    assert any(c["realized"] for c in t.fusion_candidates) \
        == (name != "lenet")
    # the hazards, but for paddle_tpu's int64 infos (the kept difference)
    jh = [d for d in j.hazards
          if not (d.pass_name == "wide-dtype" and "int64" in d.message)]
    assert _codes(t.hazards) == _codes(jh)


# ------------------------------------------------------------- cost --
def _linear(s):
    main = s.static.Program()
    with s.static.program_guard(main):
        x = s.static.data("x", [4, 16], "float32")
        out = s.nn.Linear(16, 8)(x)
    return main, out


def _matmul(s):
    main = s.static.Program()
    with s.static.program_guard(main):
        a = s.static.data("a", [3, 5], "float32")
        b = s.static.data("b", [5, 7], "float32")
        r = (s.pk.matmul(a, b) * 2.0).sum()
    return main, r


def _conv(s):
    main = s.static.Program()
    with s.static.program_guard(main):
        x = s.static.data("x", [2, 3, 8, 8], "float32")
        out = s.nn.Conv2D(3, 4, 3, padding=1)(x)
    return main, out


def _unmodeled(s):
    main = s.static.Program()
    with s.static.program_guard(main):
        x = s.static.data("x", [4, 4], "float32")
        y = s.apply(lambda a: a @ a, x, op_name="frobnicate")
    return main, y


OUT_N = 2 * 4 * 8 * 8
RULES = {
    # (program, {op: (flops, rule)}, flops_fwd)
    "linear": (_linear, {"linear": (2 * 4 * 16 * 8 + 4 * 8, "matmul")},
               2 * 4 * 16 * 8 + 4 * 8),
    "matmul": (_matmul, {"matmul": (2 * 3 * 7 * 5, "matmul"),
                         "multiply": (21, "elementwise"),
                         "sum": (21, "reduce")}, 2 * 3 * 7 * 5 + 42),
    "conv": (_conv, {"conv2d": (2 * OUT_N * 27 + OUT_N, "conv")},
             2 * OUT_N * 27 + OUT_N),
    "unmodeled": (_unmodeled, {"frobnicate": (0, "unmodeled")}, 0),
}


@pytest.mark.parametrize("case", list(RULES))
def test_cost_rules_match_hand_counts(case):
    build, want, fwd = RULES[case]
    for s in SIDES:
        main, out = build(s)
        rep = main.analyze(fetch_list=[out])
        assert {c.op_name: (c.flops, c.rule) for c in rep.per_op} == want
        assert rep.totals["flops_fwd"] == fwd
        if case == "linear":
            c = rep.per_op[0]
            assert (c.in_bytes, c.param_bytes, c.out_bytes) == (
                4 * 16 * 4, (16 * 8 + 8) * 4, 4 * 8 * 4)
        un = rep.totals["unmodeled"]
        if case == "unmodeled":
            assert not rep.per_op[0].modeled
            assert un["count"] == 1 and un["ops"] == ["frobnicate"]
            assert un["bytes"] == rep.per_op[0].total_bytes > 0
            assert un["flops_unknown"] is True
        else:
            assert un["count"] == 0


def test_batch_size_rederives_avals():
    for s in SIDES:
        main, loss = _mlp(s, hidden=8, depth=1, with_opt=False)
        r1 = main.analyze(fetch_list=[loss])
        r32 = main.analyze(fetch_list=[loss], batch_size=32)
        assert r32.totals["flops_fwd"] == 32 * r1.totals["flops_fwd"]
        assert r32.batch_hint == 32
        r8 = main.analyze(fetch_list=[loss],
                          feed_shapes={"x": (8, 8), "y": (8, 1)})
        assert r8.totals["flops_fwd"] == 8 * r1.totals["flops_fwd"]


# --------------------------------------------------------- liveness --
def _chain(s):
    main = s.static.Program()
    with s.static.program_guard(main):
        x = s.static.data("x", [256], "float32")      # 1 KiB
        a = x * 2.0
        b = a + 1.0
        c = b - 0.5
    return main, a, c


def test_activation_peak_tracks_last_use_and_fetches():
    for s in SIDES:
        main, a, c = _chain(s)
        m = main.analyze(fetch_list=[c]).memory
        assert m.activation_peak_bytes == 2 * 1024
        assert m.peak_bytes_donated == m.peak_bytes_no_donation
        assert not m.training
        assert isinstance(m, s.analysis.MemoryEstimate)
        # a fetched intermediate stays live to the end
        both = main.analyze(fetch_list=[a, c]).memory
        assert both.activation_peak_bytes == 3 * 1024


def test_training_memory_bounds_and_slots():
    for s in SIDES:
        main, loss = _mlp(s, hidden=8, depth=2)
        m = main.analyze(fetch_list=[loss], batch_size=4).memory
        assert m.retained_activation_bytes == (4 * 4 * 8 * 4) + 16 + 4
        assert m.feed_bytes == 4 * (8 + 1) * 4
        assert m.training and not m.slots_estimated
        assert m.slot_bytes == 2 * m.trainable_param_bytes
        assert m.grad_bytes == m.trainable_param_bytes
        assert (m.peak_bytes_no_donation - m.peak_bytes_donated
                == m.trainable_param_bytes + m.slot_bytes)
        main = s.static.Program()
        with s.static.program_guard(main):
            x = s.static.data("x", [None, 8], "float32")
            y = s.static.data("y", [None, 1], "float32")
            loss = s.F.mse_loss(s.static.nn.fc(x, 1), y)
            s.opt.SGD(learning_rate=0.1).minimize(loss)
        m = main.analyze(fetch_list=[loss]).memory
        assert m.slot_bytes == 0 and m.trainable_param_bytes > 0


# ----------------------------------------------------------- fusion --
def test_fusion_candidates_ranked_by_saved_traffic():
    for s in SIDES:
        main, loss = _mlp(s, hidden=16, depth=2)
        rep = main.analyze(fetch_list=[loss], batch_size=8)
        top = rep.fusion_candidates[0]
        assert top["op_names"] == ["linear", "relu"]
        assert top["saved_bytes"] == 2 * 8 * 16 * 4
        assert (top["unfused_traffic_bytes"] - top["fused_traffic_bytes"]
                == top["saved_bytes"])
        saved = [c["saved_bytes"] for c in rep.fusion_candidates]
        assert saved == sorted(saved, reverse=True)


def test_fetched_intermediate_breaks_the_chain():
    for s in SIDES:
        main = s.static.Program()
        with s.static.program_guard(main):
            x = s.static.data("x", [64], "float32")
            b = s.F.relu(x * 2.0)
            c = b + 1.0
        assert [d["op_names"] for d in main.analyze(
            fetch_list=[c]).fusion_candidates] == [
                ["multiply", "relu", "add"]]
        assert [d["op_names"] for d in main.analyze(
            fetch_list=[b, c]).fusion_candidates] == [["multiply", "relu"]]


# --------------------------------------------------------- roofline --
def test_roofline_rows_are_the_cpu_and_the_h100():
    """A kept difference: the port's rows are ``cpu`` and NVIDIA's
    published H100 SXM5 figures; a TPU row raises paddle_tpu's own
    KeyError, naming the known chips."""
    specs = tanalysis.CHIP_SPECS
    assert set(specs) == {"cpu", "h100"}
    h = specs["h100"]
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes, h.ici_bw) == (
        989e12, 3.35e12, 80 << 30, 900e9)
    assert specs["cpu"].to_dict() == janalysis.CHIP_SPECS["cpu"].to_dict()
    main, loss = _mlp(PORT)
    rep = main.analyze(fetch_list=[loss], batch_size=4)
    assert set(rep.roofline) == {"cpu", "h100"}
    for r in rep.roofline.values():
        assert r["predicted_step_s"] > 0 and 0 < r["predicted_mfu"] <= 1
        assert r["bound"] in ("compute", "memory") and r["fits_hbm"]
    assert list(main.analyze(fetch_list=[loss], chip="h100").roofline) \
        == ["h100"]
    jmain, jloss = _mlp(JAX)
    jmain.analyze(fetch_list=[jloss], chip="v5p")
    for bad in ("v5p", "v9000"):
        with pytest.raises(KeyError, match="unknown chip.*'cpu', 'h100'"):
            main.analyze(fetch_list=[loss], chip=bad)
    # per-shard pricing is ported: a plan over a one-rank mesh prices
    # every rank's share as the whole (tests/test_torch_sharding.py
    # holds the sharded figures to paddle_tpu's)
    from paddle_tpu_torch.distributed.mesh import Mesh
    from paddle_tpu_torch.distributed.sharding import plan_for_params
    plan = plan_for_params([(p.name, p) for p in main.parameters()],
                           mesh=Mesh({"dp": 1}))
    rep = main.analyze(fetch_list=[loss], sharding=plan)
    assert rep.totals["mesh_devices"] == 1
    assert rep.memory_per_shard.peak_bytes_donated \
        == rep.memory.peak_bytes_donated
    # shardcheck on an abstract mesh: no errors for a plain program
    # (tests/test_torch_shardcheck.py holds its diagnostics to
    # paddle_tpu's)
    diags = main.verify(fetch_list=[loss], mesh_shape={"dp": 2})
    assert not [d for d in diags if d.severity == "error"]


def test_perf_chip_flag_and_auto_choice():
    from paddle_tpu_torch.static.analysis.cost import resolve_perf_chip
    assert resolve_perf_chip("cpu") == "cpu"
    tset_flags({"perf_chip": "h100"})
    try:
        assert resolve_perf_chip("cpu") == "h100"
        tset_flags({"perf_chip": "v5e"})
        with pytest.warns(RuntimeWarning, match="not a known chip"):
            assert resolve_perf_chip("cpu") == "cpu"
    finally:
        tset_flags({"perf_chip": ""})


# ----------------------------------------------------------- report --
def test_report_json_roundtrip_and_render():
    for s in SIDES:
        main, loss = _mlp(s)
        rep = main.analyze(fetch_list=[loss], batch_size=4)
        assert isinstance(rep, s.analysis.ProgramReport)
        d = json.loads(rep.to_json())
        assert d["ops"] == len(main.nodes) == len(d["per_op"])
        assert d["totals"]["flops_train"] == rep.totals["flops_train"]
        assert d["memory"]["peak_bytes_donated"] > 0
        text = rep.render()
        for token in ("flops:", "memory:", "roofline", "fusion candidates",
                      "per-op:", "linear"):
            assert token in text, text


def test_anchors_flag_records_loc_without_verification():
    for s in SIDES:
        s.set_flags({"FLAGS_static_anchors": True})
        main = s.static.Program()
        with s.static.program_guard(main):
            x = s.static.data("x", [4], "float32")
            y = x * 2.0  # <- the anchor line
        s.set_flags({"FLAGS_static_anchors": False})
        assert main.nodes[0].loc[0].endswith(HERE)
        rep = main.analyze(fetch_list=[y])
        assert f"{HERE}:" in rep.per_op[0].loc
        exe = s.static.Executor()
        exe.run(main, feed={"x": np.zeros(4, np.float32)}, fetch_list=[y])
        assert exe._verified == set()


# ---------------------------------------------------------- hazards --
def test_wide_dtype_hazards_kept_differences():
    """paddle_tpu warns on float64 (narrowed to float32 there) and notes
    int64 (run as int32).  The card runs both as declared: float64 (and
    the float64 it computes) is warned of, int64 draws nothing."""
    diags = {}
    for s in SIDES:
        main = s.static.Program()
        with s.static.program_guard(main):
            a = s.static.data("a", [4], "float64")
            s.static.data("i", [4], "int64")
            b = a * 2.0
        wide = [d for d in s.analysis.check(main)
                if d.pass_name == "wide-dtype"]
        diags[s.name] = {d.var_name: d.severity for d in wide}
        main.verify()
        diags[s.name + "_b"] = b.name
    assert diags["jax"] == {"a": "warning", "i": "info"}
    assert diags["port"] == {"a": "warning", diags["port_b"]: "warning"}


def test_captured_const_hazard_severity_scales_with_bytes():
    for s in SIDES:
        main = s.static.Program()
        with s.static.program_guard(main):
            x = s.static.data("x", [300000], "float32")
            x2 = s.static.data("x2", [2048], "float32")
            x + s.pk.to_tensor(3.0)
            x2 * s.pk.to_tensor(np.ones(2048, np.float32))
            x + s.pk.to_tensor(np.ones(300000, np.float32))
        diags = [d for d in s.analysis.check(main)
                 if d.pass_name == "host-transfer"]
        assert sorted(d.severity for d in diags) == ["error", "info",
                                                     "warning"]
        err = next(d for d in diags if d.severity == "error")
        assert "baked into the" in err.message
        with pytest.raises(s.GVE, match="host-transfer"):
            main.verify()


def test_donation_alias_hazard_on_tied_params():
    for s in SIDES:
        main = s.static.Program()
        with s.static.program_guard(main):
            x = s.static.data("x", [None, 8], "float32")
            l1, l2 = s.nn.Linear(8, 8), s.nn.Linear(8, 8)
            l2.weight.data = l1.weight.data          # tied by aliasing
            l2(l1(x))
        diags = [d for d in s.analysis.check(main)
                 if d.pass_name == "donation-alias"]
        assert _codes(diags) == [("donation-alias", "warning")]
        assert "share one" in diags[0].message


def test_clean_program_has_no_hazards_and_check_stays_empty():
    for s in SIDES:
        main, loss = _mlp(s)
        assert s.analysis.check(main, fetch_list=[loss]) == []
        assert main.analyze(fetch_list=[loss]).hazards == []


# ------------------------------------------- executor integration --
def test_executor_keeps_the_prediction_on_each_build():
    """paddle_tpu records the prediction with the compile; the port keeps
    it on the built step, priced at the run's feed shapes, out of the
    build key (a new batch builds once more, for its own reason)."""
    main, loss = _mlp(PORT, hidden=8, depth=1)
    exe = pt.static.Executor()
    for bs in (4, 8):
        exe.run(main, feed={"x": np.zeros((bs, 8), np.float32),
                            "y": np.zeros((bs, 1), np.float32)},
                fetch_list=[loss])
    assert exe.compile_count == 2
    for step, bs in zip(exe._cache.values(), (4, 8)):
        want = main.analyze(fetch_list=[loss], batch_size=bs)
        p = step.predicted
        assert p["flops_fwd"] == want.totals["flops_fwd"]
        assert p["flops"] == want.totals["flops_train"]
        assert p["peak_bytes"] == want.memory.peak_bytes_donated
        assert p["unmodeled_ops"] == 0 and p["chip"] == "cpu"


def test_analyze_does_not_perturb_training():
    feed = {"x": np.ones((4, 8), np.float32),
            "y": np.ones((4, 1), np.float32)}
    runs = []
    for analyze in (False, True):
        pt.seed(0)
        main, loss = _mlp(PORT, hidden=8, depth=1)
        exe = pt.static.Executor()
        out = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])]
        if analyze:
            before = [p.detach().clone() for p in main.parameters()]
            main.analyze(fetch_list=[loss], batch_size=4)
            main.verify(fetch_list=[loss])
            assert all(torch.equal(a, b) for a, b in
                       zip(before, main.parameters()))
        out.append(float(exe.run(main, feed=feed, fetch_list=[loss])[0]))
        runs.append(out)
    assert runs[0] == runs[1]


# ------------------------------------------------------------ def-use --
def test_defuse_graph_producers_consumers():
    for s in SIDES:
        with s.static.program_guard(s.static.Program()) as main:
            x = s.static.data("x", [None, 4], "float32")
            y = x * 2.0
            z = y + 1.0
        g = s.analysis.DefUseGraph(main)
        assert g.producer_of[id(y)] == 0 and g.producer_of[id(z)] == 1
        assert g.consumers_of[id(y)] == [1]
        assert g.is_feed(x) and not g.is_feed(y)
        assert g.live_nodes([z]) == {0, 1} and g.live_nodes([y]) == {0}
        assert g.resolve_fetch(z.name) is z
        assert g.resolve_fetch("nope") is None


# ----------------------------------------------------- verifier passes --
def _xyz(s):
    with s.static.program_guard(s.static.Program()) as main:
        x = s.static.data("x", [2], "float32")
        y = x * 2.0
        z = y + 1.0
    return main, x, y, z


def _broken_reversed(s):
    main, x, y, z = _xyz(s)
    main.nodes.reverse()
    return main, [], ["used before it is produced"]


def _broken_pruned(s):
    main, x, y, z = _xyz(s)
    del main.nodes[0]
    return main, [], ["never produced"]


def _broken_duplicate(s):
    main, x, y, z = _xyz(s)
    main.nodes[1].out_vars = [y]
    return main, [], ["produced twice"]


def _broken_leak(s):
    with s.static.program_guard(s.static.Program()):
        ya = s.static.data("xa", [2], "float32") * 3.0
    with s.static.program_guard(s.static.Program()) as main:
        s.static.data("xb", [2], "float32") + ya
    return main, [], ["belongs to a different Program"]


def _dead(s):
    with s.static.program_guard(s.static.Program()) as main:
        u = s.static.data("a", [2], "float32") * 2.0
        s.static.data("b", [2], "float32") + 1.0
    return main, [u], ["dead relative to the fetch targets",
                       "feed 'b' is never consumed"]


def _bad_fetch(s):
    main, x, y, z = _xyz(s)
    return main, ["no_such_var"], ["does not name any Variable"]


def _other_fetch(s):
    main, x, y, z = _xyz(s)
    with s.static.program_guard(s.static.Program()):
        other = s.static.data("o", [2], "float32") * 1.0
    return main, [other], ["belongs to a different Program"]


def _param_drift(s):
    with s.static.program_guard(s.static.Program()) as main:
        x = s.static.data("x", [None, 4], "float32")
        lin = s.nn.Linear(4, 2)
        out = lin(x)
    assert s.analysis.check(main, fetch_list=[out]) == []
    lin.weight.data = s.zeros((5, 2))
    return main, [out], ["no longer traces"]


def _aval_corrupt(s):
    main, x, y, z = _xyz(s)
    if s is JAX:
        import jax
        y.data = jax.ShapeDtypeStruct((7,), np.float32)
    else:
        y.meta = torch.empty(7, device="meta")
    return main, [], ["recorded as shape=[7]"]


def _collision(s):
    main, x, y, z = _xyz(s)
    y.name = "x"
    return main, [], ["share the name 'x'"]


def _clean(s):
    with s.static.program_guard(s.static.Program()) as main:
        y = (s.static.data("x", [None, 4], "float32") * 2.0 + 1.0).sum()
    return main, [y], []


BROKEN = {"clean": _clean, "reversed": _broken_reversed,
          "pruned": _broken_pruned, "duplicate_producer": _broken_duplicate,
          "cross_program": _broken_leak, "dead_code": _dead,
          "unresolvable_fetch": _bad_fetch,
          "foreign_fetch": _other_fetch, "param_drift": _param_drift,
          "aval_corrupt": _aval_corrupt, "name_collision": _collision}


@pytest.mark.parametrize("case", list(BROKEN))
def test_verifier_codes_match_paddle_tpu(case):
    """The same defect in both packages: the same diagnostic codes and
    severities in the same order, and ``verify`` raises on the same."""
    got = {}
    for s in SIDES:
        main, fetch, phrases = BROKEN[case](s)
        diags = s.analysis.check(main, fetch_list=fetch)
        text = "\n".join(d.message for d in diags)
        for phrase in phrases:
            assert phrase in text, (s.name, text)
        got[s.name] = _codes(diags)
        if any(sev == "error" for _, sev in got[s.name]):
            with pytest.raises(s.GVE) as e:
                main.verify(fetch_list=fetch)
            assert e.value.diagnostics
            assert isinstance(e.value.diagnostics[0], s.analysis.Diagnostic)
            assert f"[{e.value.diagnostics[0].pass_name}]" in str(e.value)
        else:
            assert _codes(main.verify(fetch_list=fetch)) == got[s.name]
    assert got["port"] == got["jax"]
    assert bool(got["port"]) == (case != "clean")


# ------------------------------------------------ executor and flags --
def test_flag_off_executor_builds_once_without_verifying():
    main, x, y, z = _xyz(PORT)
    exe = pt.static.Executor()
    arr = np.array([1.0, 2.0], np.float32)
    r1, = exe.run(main, feed={"x": arr}, fetch_list=[z])
    r2, = exe.run(main, feed={"x": arr}, fetch_list=[z])
    np.testing.assert_array_equal(r1, r2)
    assert len(exe._cache) == 1 and exe._verified == set()
    assert all(n.loc is None for n in main.nodes)


def test_flag_on_rejects_broken_program_before_the_build():
    for s in SIDES:
        s.set_flags({"FLAGS_static_verify": True})
        main, x, y, z = _xyz(s)
        main.nodes.reverse()
        exe = s.static.Executor()
        with pytest.raises(s.GVE):
            exe.run(main, feed={"x": np.zeros(2, np.float32)},
                    fetch_list=[z])
        assert len(exe._cache) == 0


def test_flag_on_verifies_once_and_records_anchors():
    for s in SIDES:
        s.set_flags({"FLAGS_static_verify": True})
        main = s.static.Program()
        with s.static.program_guard(main):
            x = s.static.data("x", [2], "float32")
            y = x * 2.0  # <- the anchor line
        exe = s.static.Executor()
        arr = np.array([1.0, 2.0], np.float32)
        r, = exe.run(main, feed={"x": arr}, fetch_list=[y])
        np.testing.assert_array_equal(r, arr * 2.0)
        assert exe._verified == {(main._serial, main._version)}
        exe.run(main, feed={"x": arr}, fetch_list=[y])
        assert len(exe._verified) == 1
        loc = main.nodes[0].loc
        assert loc[0].endswith(HERE) and loc[1] > 0
        with s.static.program_guard(main):
            y + 1.0
        main.nodes.reverse()
        d = next(d for d in s.analysis.check(main)
                 if d.pass_name == "use-before-produce")
        assert f"{HERE}:" in str(d)


def test_program_serials_are_monotonic_and_versions_evict():
    p1, p2 = pt.static.Program(), pt.static.Program()
    assert p2._serial > p1._serial >= 0
    exe = pt.static.Executor()
    main = pt.static.Program()
    with pt.static.program_guard(main):
        y = pt.static.data("x", [None, 2], "float32") * 2.0
    feed = {"x": np.ones((1, 2), np.float32)}
    exe.run(main, feed=feed, fetch_list=[y])
    for _ in range(3):
        with pt.static.program_guard(main):
            y = y + 1.0
        out, = exe.run(main, feed=feed, fetch_list=[y])
    np.testing.assert_array_equal(out, [[5.0, 5.0]])
    assert len(exe._cache) == 1 and exe.compile_count == 4
    exe.close()
    assert exe._cache == {} and exe._states == {}


def test_static_training_runs_under_verification():
    """test_static_analysis.py's end-to-end case: a small regression
    trains 40 SGD runs with FLAGS_static_verify on, on both packages
    from the same weights, the last loss below a fifth of the first."""
    from paddle_tpu_torch.framework_io import program_state_from_paddle_tpu
    losses = {}
    for s in SIDES:
        s.set_flags({"FLAGS_static_verify": True})
        s.seed(0)
        main = s.static.Program()
        with s.static.program_guard(main):
            x = s.static.data("x", [None, 8], "float32")
            y = s.static.data("y", [None, 1], "float32")
            loss = s.F.mse_loss(s.static.nn.fc(x, 1), y)
            s.opt.SGD(learning_rate=0.05).minimize(loss)
        if s is PORT:
            program_state_from_paddle_tpu(main, weights)
        else:
            weights = [np.asarray(p.data) for p in main.parameters()]
        exe = s.static.Executor()
        r = np.random.RandomState(1)
        xs = r.standard_normal((32, 8)).astype(np.float32)
        ys = xs @ r.standard_normal((8, 1)).astype(np.float32)
        losses[s.name] = [float(exe.run(main, feed={"x": xs, "y": ys},
                                        fetch_list=[loss])[0])
                          for _ in range(40)]
        assert losses[s.name][-1] < 0.2 * losses[s.name][0]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
