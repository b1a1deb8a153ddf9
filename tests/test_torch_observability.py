"""paddle_tpu_torch's observability package held to paddle_tpu's on the
CPU: the cases of ``tests/test_observability.py`` that read no JAX
internals, each run on both packages where both can run it.

- The SLO and quantile math agree exactly on the same monitor streams
  (every poll's status but its wall-clock ``time``).
- The Prometheus text of the same registry contents agrees line for
  line, apart from ``build_info``'s labels (each package names its own
  stack).
- The compile causes come in the same order (the static Executor, the
  Predictor's buckets, ``to_static``'s captures).
- The tracer, flight recorder, metrics dump and rotation, engine
  labels and ``/healthz`` degradation behave alike.

Twinned elsewhere:
- ``test_record_event_end_without_begin_is_noop``,
  ``test_record_event_exception_safe_and_nested_under_tracer`` and the
  ``RecordEvent`` half of ``test_tracer_records_ops_and_spans_with_
  nesting``: in ``tests/test_torch_profiler.py``, beside the profiler
  (the span nesting is held through ``Tracer.span`` here);
- ``test_metrics_dump_callback``: ``hapi.callbacks.MetricsDump`` is
  held in ``tests/test_torch_hapi.py``.

Left out, with the reason:
- ``test_perf_report_cli_multiline_jsonl_and_flight`` and
  ``test_obs_smoke_in_process``: ``tools/perf_report.py`` and
  ``tools/obs_smoke.py`` are the JAX package's CLI and gate (A7); the
  disabled-path half of the gate is ported below.
- The memory half of ``test_perf_step_anatomy_and_memory_from_executor``
  runs only on the port's side with no card: paddle_tpu sizes its CPU
  backend's live arrays, the port reads the CUDA allocator and gives
  ``{}`` without a card (ROADMAP §C).
"""
import json
import os
import re
import sys
import types

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import observability as jax_obs
from paddle_tpu.core import dispatch as jax_dispatch
from paddle_tpu.core import enforce as jax_enforce
from paddle_tpu.core import obs_hook as jax_hook
from paddle_tpu.serving import http as jax_http
from paddle_tpu.testing import fault as jax_fault
from paddle_tpu.utils import monitor as jax_monitor
from paddle_tpu_torch import observability as port_obs
from paddle_tpu_torch.core import dispatch as port_dispatch
from paddle_tpu_torch.core import enforce as port_enforce
from paddle_tpu_torch.core import obs_hook as port_hook
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.serving import http as port_http
from paddle_tpu_torch.testing import fault as port_fault
from paddle_tpu_torch.utils import monitor as port_monitor

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", pkg=paddle_tpu, obs=jax_obs, monitor=jax_monitor,
        hook=jax_hook, fault=jax_fault, enforce=jax_enforce,
        dispatch=jax_dispatch, http=jax_http),
    "port": types.SimpleNamespace(
        name="port", pkg=paddle_tpu_torch, obs=port_obs,
        monitor=port_monitor, hook=port_hook, fault=port_fault,
        enforce=port_enforce, dispatch=port_dispatch, http=port_http),
}
SIDES = sorted(PKGS)
PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+naif]+$")


def _clean(side):
    side.obs.disable()
    side.obs.uninstall_flight_recorder()
    side.obs.disable_perf()
    side.obs.uninstall_slo_monitor()


@pytest.fixture(autouse=True)
def _clean_obs():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    for side in PKGS.values():
        _clean(side)
    yield
    for side in PKGS.values():
        _clean(side)
    placement.set_default(prev)


def _static_mlp(side, seed=7, in_dim=8):
    pkg = side.pkg
    pkg.seed(seed)
    main = pkg.static.Program()
    with pkg.static.program_guard(main):
        x = pkg.static.data("x", [None, in_dim], "float32")
        y = pkg.static.data("y", [None, 1], "float32")
        h = pkg.static.nn.fc(x, 16, activation="relu")
        pred = pkg.static.nn.fc(h, 1)
        loss = pkg.nn.functional.mse_loss(pred, y)
        pkg.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main, loss


def _feed(n, in_dim=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, in_dim).astype(np.float32),
            "y": rng.randn(n, 1).astype(np.float32)}


def _static(side, fn):
    side.pkg.enable_static()
    try:
        return fn()
    finally:
        side.pkg.disable_static()
        side.pkg.static.reset_default_programs()


def _no_time(st):
    return {k: v for k, v in st.items() if k != "time"}


# ---------------------------------------------------------------- tracer --
def test_disabled_path_contract():
    """Off means ONE module-attribute check, and the monitor hot paths
    never grew an observability hook."""
    obs, hook = port_obs, port_hook
    assert hook.current() is None and not obs.enabled()
    assert hook.current.__code__.co_names == ("_tracer",)
    names = port_dispatch.apply.__code__.co_names
    assert "obs_hook" in names and "_tracer" in names
    assert "observability" not in names
    for fn in (port_monitor.stat_add, port_monitor.stat_observe,
               port_monitor.StatRegistry.add,
               port_monitor.StatRegistry.observe,
               port_monitor._Histogram.observe):
        names = fn.__code__.co_names
        assert not any(n in ("obs_hook", "_tracer", "observability",
                             "tracer", "emit") for n in names), names
    obs.emit("instant", "nope")
    obs.counter("nope", 1)
    obs.set_step(3)
    with obs.span("nope"):
        pass


@pytest.mark.parametrize("name", SIDES)
def test_tracer_records_ops_and_spans_with_nesting(name):
    side = PKGS[name]
    t = side.obs.enable(capacity=256)
    x = side.pkg.to_tensor(np.ones((2, 3), np.float32))
    with side.obs.span("outer"):
        with side.obs.span("inner"):
            _ = side.pkg.nn.functional.relu(x)
    evs = t.events()
    assert {"op", "span"} <= {e["kind"] for e in evs}
    spans = {e["name"]: e for e in evs if e["kind"] == "span"}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["outer"].get("parent") is None
    ops = [e for e in evs if e["kind"] == "op"]
    assert ops and all(e["dur"] >= 0 for e in ops)
    assert "relu" in {e["name"] for e in ops}
    # the op ran inside the inner span: it hangs off it
    relu = next(e for e in ops if e["name"] == "relu")
    assert relu["parent"] == spans["inner"]["id"]


def test_tracer_op_events_can_be_turned_off():
    t = port_obs.enable(capacity=64, trace_ops=False)
    port_obs.emit("instant", "x")
    _ = paddle_tpu_torch.nn.functional.relu(
        paddle_tpu_torch.to_tensor(np.ones(3, np.float32)))
    assert [e["kind"] for e in t.events()] == ["instant"]


@pytest.mark.parametrize("name", SIDES)
def test_tracer_ring_buffer_bounds_memory(name):
    t = PKGS[name].obs.enable(capacity=16)
    for i in range(100):
        t.emit("instant", f"e{i}")
    evs = t.events()
    assert len(evs) == 16 and evs[-1]["name"] == "e99"
    assert t.emitted == 100


@pytest.mark.parametrize("name", SIDES)
def test_chrome_trace_schema_and_jsonl(tmp_path, name):
    t = PKGS[name].obs.enable(capacity=256)
    with t.span("phase", detail=1):
        t.counter("c", 2)
        t.emit("instant", "marker")
    trace = t.chrome_trace()
    phs = set()
    for ev in trace["traceEvents"]:
        assert isinstance(ev["name"], str)
        assert ev["ph"] in {"X", "i", "C", "B", "E", "M"}
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        phs.add(ev["ph"])
    assert {"X", "i", "C"} <= phs
    p = tmp_path / "trace.json"
    t.export_chrome_trace(str(p))
    json.load(open(p))
    rows = [json.loads(ln) for ln in
            t.export_jsonl(str(tmp_path / "t.jsonl")).splitlines()]
    assert rows and all("kind" in r and "time" in r for r in rows)


@pytest.mark.parametrize("name", SIDES)
def test_step_correlation_from_executor(name):
    side = PKGS[name]
    t = side.obs.enable()

    def run():
        main, loss = _static_mlp(side)
        exe = side.pkg.static.Executor()
        for _ in range(3):
            exe.run(main, feed=_feed(8), fetch_list=[loss])
        exe.close()
    _static(side, run)
    runs = [e for e in t.events()
            if e["kind"] == "span" and e["name"] == "executor.run"]
    assert [e["step"] for e in runs] == [1, 2, 3]


@pytest.mark.parametrize("name", SIDES)
def test_end_span_with_foreign_id_does_not_drain_stack(name):
    t = PKGS[name].obs.enable()
    outer = t.begin_span("outer")
    inner = t.begin_span("inner")
    t.end_span(inner)
    t.end_span(inner)
    t.end_span(99999)
    assert not [e for e in t.events() if e["name"] == "outer"]
    t.end_span(outer)
    spans = {e["name"]: e for e in t.events() if e["kind"] == "span"}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert len([e for e in t.events() if e["name"] == "inner"]) == 1


@pytest.mark.parametrize("name", SIDES)
def test_tracer_ring_drop_accounting(tmp_path, name):
    side = PKGS[name]
    t = side.obs.enable(capacity=16)
    for i in range(100):
        t.emit("instant", f"e{i}")
    assert t.emitted == 100 and t.dropped == 84 and t.high_watermark == 16
    assert t.ring_stats() == {"events_emitted": 100, "events_dropped": 84,
                              "ring_capacity": 16,
                              "ring_high_watermark": 16}
    assert side.monitor.get_stat("obs.events_dropped") == 84
    assert "paddle_tpu_obs_events_dropped 84" in side.obs.prometheus_text()
    box = json.load(open(side.obs.dump_flight(
        path=str(tmp_path / "f.json"), reason="drop-test")))
    assert box["obs"]["events_dropped"] >= 84
    t2 = side.obs.enable(capacity=64)
    for i in range(5):
        t2.emit("instant", f"x{i}")
    assert t2.dropped == 0 and t2.high_watermark == 5


def test_lenet_step_op_events_on_each_package():
    """The op events of one eager LeNet training step (the count ROADMAP
    §C records): both packages emit op events for it."""
    counts = {}
    for name in SIDES:
        side = PKGS[name]
        pkg = side.pkg
        pkg.seed(0)
        model = pkg.vision.models.LeNet()
        opt = pkg.optimizer.Adam(learning_rate=1e-3,
                                 parameters=model.parameters())
        rs = np.random.RandomState(0)
        x = pkg.to_tensor(rs.randn(4, 1, 28, 28).astype("float32"))
        y = pkg.to_tensor(rs.randint(0, 10, (4,)).astype("int64"))

        def step():
            loss = pkg.nn.functional.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss)
        step()
        t = side.obs.enable(capacity=65536)
        step()
        counts[name] = sum(e["kind"] == "op" for e in t.events())
        side.obs.disable()
    # paddle_tpu 11, the port 14 when this was written: the ops that
    # reach ``apply`` differ (the port's layers and optimizer call torch
    # directly; its loss and activation functions pass through it)
    assert all(5 <= n <= 50 for n in counts.values()), counts


# ------------------------------------------------------ quantile math ----
def _both_quantiles(fill, qs):
    out = {}
    for name in SIDES:
        m = PKGS[name].monitor
        m.stat_reset("q.t")
        fill(m)
        out[name] = [m.quantile("q.t", q) for q in qs]
        m.stat_reset("q.t")
    return out


@pytest.mark.parametrize("case", ["edges", "single", "within", "extremes"])
def test_quantile_math_agrees_exactly(case):
    if case == "edges":
        def fill(m):
            for v in [1.0] * 4 + [1200.0] * 4:
                m.stat_observe("q.t", v)
        qs = [0.5, 0.5001, 5.0 / 8.0]
        want = [10.0 ** (1.0 / 8.0), None,
                1000.0 + (10.0 ** 3.125 - 1000.0) * 0.25]
    elif case == "single":
        def fill(m):
            for _ in range(10):
                m.stat_observe("q.t", 3.7)
        qs = [0.1, 0.25, 0.5, 0.9, 0.99]
        want = [3.7] * 5
    elif case == "within":
        def fill(m):
            for v in (10.1, 10.4, 10.8, 12.0):
                m.stat_observe("q.t", v)
        qs = [0.5]
        want = [10.0 + (10.0 ** (9.0 / 8.0) - 10.0) * 0.5]
    else:
        def fill(m):
            for v in (0.5, 2.0, 7.0):
                m.stat_observe("q.t", v)
        qs = [0.0, 1.0]
        want = [0.5, 7.0]
    got = _both_quantiles(fill, qs)
    assert got["port"] == got["jax"]        # bit for bit
    for g, w in zip(got["port"], want):
        if w is not None:
            assert g == pytest.approx(w)


def test_quantile_from_counts_windowed_delta_agrees():
    got = {}
    for name in SIDES:
        m = PKGS[name].monitor
        m.stat_reset("q.win")
        for _ in range(10):
            m.stat_observe("q.win", 1.0)
        base = m.histogram_raw("q.win")
        for _ in range(10):
            m.stat_observe("q.win", 1200.0)
        cur = m.histogram_raw("q.win")
        counts = [a - b for a, b in zip(cur["counts"], base["counts"])]
        n = cur["count"] - base["count"]
        got[name] = (m.quantile_from_counts(counts, n, 0.5),
                     m.quantile_from_counts(counts, 0, 0.5),
                     m.quantile("q.win", 0.4))
        m.stat_reset("q.win")
    assert got["port"] == got["jax"]
    lo, hi = 1000.0, 10.0 ** 3.125
    assert got["port"][0] == pytest.approx(lo + (hi - lo) * 0.5)
    assert got["port"][1] == 0.0 and got["port"][2] < 100.0


# ---------------------------------------------- recompile attribution ----
def test_executor_compile_causes_in_the_same_order():
    causes = {}
    for name in SIDES:
        side = PKGS[name]
        side.obs.reset_compiles()

        def run():
            main, loss = _static_mlp(side)
            exe = side.pkg.static.Executor()
            exe.run(main, feed=_feed(8), fetch_list=[loss])
            exe.run(main, feed=_feed(8, seed=1), fetch_list=[loss])
            exe.run(main, feed=_feed(4), fetch_list=[loss])
            with side.pkg.static.program_guard(main):
                side.pkg.static.nn.fc(main.feed_vars["x"], 4)
            exe.run(main, feed=_feed(4), fetch_list=[loss])
            exe.close()
        _static(side, run)
        rep = side.obs.explain_compiles("executor")
        causes[name] = [r["cause"] for r in rep["records"]]
        assert rep["unexplained"] == 0
        assert "feed_signature" in rep["records"][1]["changed"]
        assert side.monitor.get_stat(
            "compiles.executor.new_feed_signature") >= 1
    assert causes["port"] == ["first_compile", "new_feed_signature",
                              "new_program_version"]
    assert causes["port"] == causes["jax"]


def test_predictor_compile_causes_in_the_same_order(tmp_path):
    got = {}
    for name in SIDES:
        side = PKGS[name]
        side.obs.reset_compiles()
        side.pkg.seed(0)
        model = side.pkg.nn.Sequential(side.pkg.nn.Linear(4, 2))
        prefix = str(tmp_path / name)
        side.pkg.jit.save(model, prefix, input_spec=[
            side.pkg.jit.InputSpec([None, 4], "float32")])
        pred = side.pkg.inference.create_predictor(
            side.pkg.inference.Config(prefix))
        for n in (1, 2, 3, 5):
            pred.run([np.zeros((n, 4), np.float32)])
        rep = side.obs.explain_compiles("predictor")
        got[name] = [r["cause"] for r in rep["records"]]
        assert len(rep["records"]) == pred.num_compiled_variants()
        assert rep["unexplained"] == 0
    assert got["port"][0] == "first_compile"
    assert set(got["port"][1:]) == {"new_bucket"}
    assert got["port"] == got["jax"]


def test_jit_compile_causes_in_the_same_order():
    got = {}
    for name in SIDES:
        side = PKGS[name]
        side.obs.reset_compiles()

        @side.pkg.jit.to_static
        def f(a, scale):
            return a * scale

        x = side.pkg.to_tensor(np.ones((2, 2), np.float32))
        f(x, 2.0)
        f(x, 2.0)           # cache hit: no new record
        f(x, 3.0)           # new static-leaf value
        rep = side.obs.explain_compiles("jit")
        got[name] = [r["cause"] for r in rep["records"]]
        assert rep["unexplained"] == 0
    assert got["port"] == ["first_compile", "new_input_structure"]
    assert got["port"] == got["jax"]


def test_jit_compile_causes_for_varying_and_unhashable_leaves():
    """Static leaves are keyed by hash: ``2`` after ``2.0`` is no new
    capture, and a numpy argument is captured anew on every call, also
    one whose truncated repr equals an earlier one's."""
    got = {}
    for name in SIDES:
        side = PKGS[name]
        side.obs.reset_compiles()

        @side.pkg.jit.to_static
        def f(a, scale):
            return a * float(np.sum(scale))

        x = side.pkg.to_tensor(np.ones((2, 2), np.float32))
        f(x, 2.0)
        f(x, 2)             # equal hash: the same capture
        f(x, 2.5)
        big = np.zeros(4096, np.float32)
        other = big.copy()
        other[2048] = 1.0
        assert repr(big) == repr(other)
        f(x, big)
        f(x, big)
        np.testing.assert_array_equal(f(x, other).numpy(),
                                      np.ones((2, 2), np.float32))
        rep = side.obs.explain_compiles("jit")
        got[name] = [r["cause"] for r in rep["records"]]
        assert rep["unexplained"] == 0
    assert got["port"] == ["first_compile", "new_input_structure"] + \
        ["new_uncacheable_call"] * 3
    assert got["port"] == got["jax"]


def test_generation_variants_are_attributed():
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.testing.chaos import make_dyadic_lm
    port_obs.reset_compiles()
    eng = serving.GenerationEngine(make_dyadic_lm(), num_slots=2,
                                   page_size=4, max_context=16,
                                   prompt_buckets=[4])
    try:
        n = eng.warmup()
    finally:
        eng.close()
    rep = port_obs.explain_compiles("generation")
    assert len(rep["records"]) == n
    assert rep["records"][0]["cause"] == "first_compile"
    assert all(r["note"] == "warmup" for r in rep["records"])


@pytest.mark.parametrize("name", SIDES)
def test_annotate_and_reset_compiles(name):
    obs = PKGS[name].obs
    obs.reset_compiles()
    obs.record_compile("unit", 1, {"a": 1})
    obs.record_compile("unit", 1, {"a": 1})         # nothing changed
    assert obs.annotate_compile("unit", 1, "loaded")
    assert not obs.annotate_compile("unit", 2, "loaded")
    rep = obs.explain_compiles("unit")
    assert [r["cause"] for r in rep["records"]] == ["first_compile",
                                                    "unexplained"]
    assert rep["unexplained"] == 1 and rep["records"][-1]["cache"] == "loaded"
    obs.reset_compiles()
    assert obs.explain_compiles("unit")["total"] == 0


# ------------------------------------------------------ metrics export ---
def _prom_without_build_info(side, extra=None):
    return [ln for ln in side.obs.prometheus_text(extra).splitlines()
            if not ln.startswith("paddle_tpu_build_info{")]


def test_prometheus_text_agrees_line_for_line():
    texts = {}
    for name in SIDES:
        m = PKGS[name].monitor
        m.stat_reset()
        m.stat_add("obs.test.counter", 5)
        m.stat_set("obs.test.gauge", 2.5)
        for v in (2.5, 7.0, 120.0):
            m.stat_observe("obs.test.lat", v)
        m.stat_add("clash", 1)
        m.stat_observe("clash", 2.0)
        texts[name] = _prom_without_build_info(
            PKGS[name], {"extra_gauge": 1.25,
                         'serving_engine_queue_depth{engine="b"}': 3})
        m.stat_reset()
    assert texts["port"] == texts["jax"]
    for line in texts["port"]:
        if line and not line.startswith("#"):
            assert PROM_LINE.match(line), line
    text = "\n".join(texts["port"])
    assert "paddle_tpu_obs_test_counter 5" in text
    assert 'paddle_tpu_obs_test_lat{quantile="0.5"} ' in text
    assert "paddle_tpu_obs_test_lat_count 3" in text
    assert "paddle_tpu_clash_stat 1" in text        # renamed, no collision
    assert "paddle_tpu_extra_gauge 1.25" in text


@pytest.mark.parametrize("name", SIDES)
def test_prometheus_extra_gauges_join_families_one_type_line(name):
    side = PKGS[name]
    side.monitor.stat_reset("promfam.reqs")
    side.monitor.stat_add("promfam.reqs", 3)
    try:
        text = side.obs.prometheus_text({
            'promfam_reqs{engine="a"}': 1, 'promfam_reqs{engine="b"}': 2,
            "promfam_reqs": 9})
    finally:
        side.monitor.stat_reset("promfam.reqs")
    lines = text.splitlines()
    fam = [i for i, ln in enumerate(lines)
           if ln.startswith("paddle_tpu_promfam_reqs")
           or ln == "# TYPE paddle_tpu_promfam_reqs gauge"]
    assert sum(ln.startswith("# TYPE paddle_tpu_promfam_reqs")
               for ln in lines) == 1
    assert fam == list(range(fam[0], fam[0] + len(fam)))
    assert "paddle_tpu_promfam_reqs 3" in lines
    assert "paddle_tpu_promfam_reqs 9" not in lines


@pytest.mark.parametrize("name", SIDES)
def test_metrics_snapshot_and_jsonl_dump(tmp_path, name):
    side = PKGS[name]
    side.monitor.stat_add("snap.c", 2)
    snap = side.obs.metrics_snapshot()
    assert snap["stats"]["snap.c"] >= 2 and "histograms" in snap
    p = str(tmp_path / "metrics.jsonl")
    side.obs.dump_metrics(p, extra={"tag": "t1"})
    side.obs.dump_metrics(p, extra={"tag": "t2"})
    rows = [json.loads(ln) for ln in open(p).read().splitlines()]
    assert [r["tag"] for r in rows] == ["t1", "t2"]
    with pytest.raises(ValueError):
        side.obs.dump_metrics()


@pytest.mark.parametrize("name", SIDES)
def test_metrics_dump_path_flag_is_the_default(tmp_path, name):
    side = PKGS[name]
    p = str(tmp_path / "flag.jsonl")
    old = side.pkg.get_flags(["metrics_dump_path"])
    side.pkg.set_flags({"metrics_dump_path": p})
    try:
        assert side.obs.dump_metrics() == p
    finally:
        side.pkg.set_flags(old)
    assert len(open(p).read().splitlines()) == 1


@pytest.mark.parametrize("name", SIDES)
def test_metrics_dump_rotation_bounds_file_growth(tmp_path, name):
    side = PKGS[name]
    old = side.pkg.get_flags(["metrics_dump_max_mb", "metrics_dump_keep"])
    side.pkg.set_flags({"metrics_dump_max_mb": 1e-4,
                        "metrics_dump_keep": 2})
    p = str(tmp_path / "metrics.jsonl")
    try:
        for _ in range(4):
            side.obs.dump_metrics(p)
        assert os.path.exists(p + ".1") and os.path.exists(p + ".2")
        assert not os.path.exists(p + ".3")
        for path in (p, p + ".1", p + ".2"):
            rows = [json.loads(ln) for ln in open(path).read().splitlines()]
            assert rows and all("stats" in r for r in rows)
        assert len(open(p).read().splitlines()) == 1
    finally:
        side.pkg.set_flags(old)


@pytest.mark.parametrize("name", SIDES)
def test_metrics_dump_no_rotation_when_flag_unset(tmp_path, name):
    p = str(tmp_path / "metrics.jsonl")
    for _ in range(3):
        PKGS[name].obs.dump_metrics(p)
    assert len(open(p).read().splitlines()) == 3
    assert not os.path.exists(p + ".1")


def test_build_info_names_the_port_torch_cuda_and_the_card():
    import torch
    info = port_obs.build_info()
    assert info["framework"] == paddle_tpu_torch.__version__
    assert info["torch"] == torch.__version__
    assert info["cuda"] == str(torch.version.cuda)
    assert info["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    assert "device" in info
    assert port_obs.metrics_snapshot()["build"] == info
    line = next(ln for ln in port_obs.prometheus_text().splitlines()
                if ln.startswith("paddle_tpu_build_info{"))
    assert PROM_LINE.match(line) and line.endswith(" 1")
    assert f'torch="{info["torch"]}"' in line


@pytest.mark.parametrize("name", SIDES)
def test_metrics_snapshot_carries_slo_perf_and_drop_blocks(name):
    side = PKGS[name]
    t = side.obs.enable(capacity=32)
    side.obs.enable_perf(sample_every=0)
    side.monitor.stat_reset("slo.t.snap")
    m = side.obs.install_slo_monitor([side.obs.SLORule(
        "slo.t.snap", 1.0, window=5.0, name="snap_rate")])
    m.poll(now=1.0)
    t.emit("instant", "x")
    snap = side.obs.metrics_snapshot()
    assert "histograms" in snap and "stats" in snap
    assert snap["obs"]["ring_capacity"] == 32
    assert snap["slo"]["installed"] is True
    assert snap["slo"]["rules"][0]["name"] == "snap_rate"
    assert snap["perf"]["enabled"] is True
    side.monitor.stat_reset("slo.t.snap")


@pytest.mark.parametrize("name", SIDES)
def test_engine_label_escapes_prometheus_value(name):
    label = PKGS[name].http._engine_label
    assert label(None) == "" and label("") == ""
    assert label("bert") == '{engine="bert"}'
    assert label('a"b\\c\nd') == r'{engine="a\"b\\c\nd"}'


# ------------------------------------------------------------ serving ----
def _linear_engine(side, tmp_path, **kw):
    side.pkg.seed(0)
    model = side.pkg.nn.Sequential(side.pkg.nn.Linear(4, 2))
    prefix = str(tmp_path / f"m_{side.name}")
    side.pkg.jit.save(model, prefix, input_spec=[
        side.pkg.jit.InputSpec([None, 4], "float32")])
    pred = side.pkg.inference.create_predictor(
        side.pkg.inference.Config(prefix))
    eng = side.pkg.serving.InferenceEngine(pred, max_batch_size=4,
                                           batch_timeout_ms=1.0, **kw)
    eng.warmup()
    return eng


@pytest.mark.parametrize("name", SIDES)
def test_http_metrics_content_negotiation(tmp_path, name):
    side = PKGS[name]
    engine = _linear_engine(side, tmp_path)
    engine.infer_sync([np.zeros((1, 4), np.float32)], timeout=30)
    try:
        with side.pkg.serving.ServingServer(engine, port=0) as srv:
            client = side.pkg.serving.Client(srv.url)
            assert client.metrics()["counters"]["responses"] >= 1
            text = client.metrics_text()
            assert text.startswith("# TYPE")
            assert "paddle_tpu_serving_engine_queue_depth" in text
            for line in text.splitlines():
                if line and not line.startswith("#"):
                    assert PROM_LINE.match(line), line
            client.close()
    finally:
        engine.close()


@pytest.mark.parametrize("name", SIDES)
def test_serving_events_carry_request_ids(tmp_path, name):
    side = PKGS[name]
    engine = _linear_engine(side, tmp_path)
    t = side.obs.enable()
    engine.infer_sync([np.zeros((2, 4), np.float32)], timeout=30)
    engine.drain(timeout=10)
    engine.close()
    sv = [e for e in t.events() if e["kind"] == "serving"]
    enq = [e for e in sv if e["name"] == "enqueue"]
    disp = [e for e in sv if e["name"] == "dispatch"]
    assert enq and disp
    assert enq[0]["args"]["rid"] in disp[0]["args"]["rids"]
    assert disp[0]["args"]["ok"] is True and disp[0]["dur"] >= 0


@pytest.mark.parametrize("name", SIDES)
def test_engine_name_mirrors_stats_and_labels_gauges(tmp_path, name):
    side = PKGS[name]
    side.monitor.stat_reset("serving.engine.bert.requests")
    side.monitor.stat_reset("serving.engine.bert.batches")
    side.monitor.stat_reset("serving.engine.bert.latency_ms")
    engine = _linear_engine(side, tmp_path, name="bert")
    try:
        engine.infer_sync([np.zeros((2, 4), np.float32)], timeout=30)
        assert engine.stats()["engine"] == "bert"
        assert side.monitor.get_stat("serving.engine.bert.requests") == 1
        assert side.monitor.get_stat("serving.engine.bert.batches") == 1
        assert side.monitor.histogram_summary(
            "serving.engine.bert.latency_ms")["count"] == 1
        with side.pkg.serving.ServingServer(engine, port=0) as srv:
            client = side.pkg.serving.Client(srv.url)
            text = client.metrics_text()
            client.close()
        assert ('paddle_tpu_serving_engine_queue_depth{engine="bert"}'
                in text)
        assert "paddle_tpu_serving_engine_bert_requests 1" in text
    finally:
        engine.close()


@pytest.mark.parametrize("name", SIDES)
def test_healthz_slo_degradation_and_recovery(tmp_path, name):
    import time
    side = PKGS[name]
    engine = _linear_engine(side, tmp_path, name="h")
    side.monitor.stat_reset("slo.h.lat")
    side.obs.install_slo_monitor([side.obs.SLORule(
        "slo.h.lat", 10.0, window=0.5, quantile=0.5, name="h_lat")])
    side.obs.slo_status()                   # base snapshot
    try:
        with side.pkg.serving.ServingServer(engine, port=0) as srv:
            client = side.pkg.serving.Client(srv.url)
            h = client.healthz()
            assert h["status"] == "running" and h["slo"] == "ok"
            for _ in range(4):
                side.monitor.stat_observe("slo.h.lat", 500.0)
            h = client.healthz()
            assert h["status"] == "degraded"
            assert h["engine_state"] == "running"
            assert h["slo"]["breached"] == ["h_lat"]
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                time.sleep(0.2)
                h = client.healthz()
                if h["status"] == "running":
                    break
            assert h["status"] == "running" and h["slo"] == "ok"
            p = client.perf()
            assert p["perf"] == {"enabled": False}
            assert p["slo"]["installed"] is True
            client.close()
    finally:
        engine.close()
        side.monitor.stat_reset("slo.h.lat")


# --------------------------------------------------- flight recorder -----
@pytest.mark.parametrize("name", SIDES)
def test_flight_recorder_on_executor_crash(tmp_path, name):
    side = PKGS[name]
    t = side.obs.enable()
    flight = str(tmp_path / "flight.json")
    side.obs.install_flight_recorder(path=flight)

    def run():
        main, loss = _static_mlp(side)
        exe = side.pkg.static.Executor()
        exe.run(main, feed=_feed(8), fetch_list=[loss])
        with side.fault.inject("executor.run:count=1"):
            with pytest.raises(side.fault.FaultInjected):
                exe.run(main, feed=_feed(8), fetch_list=[loss])
        exe.close()
    _static(side, run)
    box = json.load(open(flight))
    assert box["exception"]["type"] == "FaultInjected"
    assert "executor.run" in box["reason"]
    kinds = {e["kind"] for e in box["events"]}
    assert "fault" in kinds and "compile" in kinds
    assert box["stats"] and "histograms" in box
    assert box["compiles"]["total"] >= 1
    assert t.events()


@pytest.mark.parametrize("name", SIDES)
def test_flight_recorder_on_enforce_error(tmp_path, name):
    side = PKGS[name]
    flight = str(tmp_path / "flight.json")
    side.obs.install_flight_recorder(path=flight)
    with pytest.raises(side.enforce.InvalidArgumentError):
        side.enforce.enforce(False, "observability test failure")
    box = json.load(open(flight))
    assert box["reason"].startswith("enforce.")
    assert box["exception"]["type"] == "InvalidArgumentError"
    assert "observability test failure" in box["exception"]["message"]


@pytest.mark.parametrize("name", SIDES)
def test_flight_recorder_same_exception_dumps_once(tmp_path, name):
    side = PKGS[name]
    side.obs.install_flight_recorder(path=str(tmp_path / "flight.json"))
    side.monitor.stat_reset("flight.dumps")

    def run():
        main, loss = _static_mlp(side)
        exe = side.pkg.static.Executor()
        with side.fault.inject("executor.run:count=1,exc=FaultInjected"):
            with pytest.raises(side.fault.FaultInjected):
                exe.run(main, feed=_feed(8), fetch_list=[loss])
        exe.close()
    _static(side, run)
    assert side.monitor.get_stat("flight.dumps") == 1


@pytest.mark.parametrize("name", SIDES)
def test_flight_recorder_distinct_exceptions_each_dump(tmp_path, name):
    side = PKGS[name]
    flight = str(tmp_path / "flight.json")
    side.obs.install_flight_recorder(path=flight)
    side.monitor.stat_reset("flight.dumps")
    for i in range(5):
        side.enforce.InvalidArgumentError(f"err {i}")
    assert side.monitor.get_stat("flight.dumps") == 5
    assert "err 4" in json.load(open(flight))["exception"]["message"]


@pytest.mark.parametrize("name", SIDES)
def test_flight_recorder_traceback_upgrades_dump(tmp_path, name):
    side = PKGS[name]
    flight = str(tmp_path / "flight.json")
    side.obs.install_flight_recorder(path=flight)
    side.monitor.stat_reset("flight.dumps")

    def deep():
        raise side.enforce.NotFoundError("lost thing")

    try:
        deep()
    except side.enforce.NotFoundError as e:
        side.hook.crash_handler()(e, "executor.run(test)")
        side.hook.crash_handler()(e, "executor.run(test)")
    assert side.monitor.get_stat("flight.dumps") == 2
    assert "deep" in "".join(json.load(open(flight))["exception"]["traceback"])


@pytest.mark.parametrize("name", SIDES)
def test_flight_recorder_uninstall_restores_hooks(tmp_path, name):
    side = PKGS[name]
    prev_hook = sys.excepthook
    side.obs.install_flight_recorder(path=str(tmp_path / "f.json"))
    assert sys.excepthook is not prev_hook
    assert side.hook.crash_handler() is not None
    assert side.obs.flight_recorder_path() == str(tmp_path / "f.json")
    side.obs.uninstall_flight_recorder()
    assert sys.excepthook is prev_hook
    assert side.hook.crash_handler() is None
    assert side.obs.flight_recorder_path() is None


@pytest.mark.parametrize("name", SIDES)
def test_flight_recorder_path_flag_is_the_default(tmp_path, name):
    side = PKGS[name]
    p = str(tmp_path / "flag_box.json")
    old = side.pkg.get_flags(["flight_recorder_path"])
    side.pkg.set_flags({"flight_recorder_path": p})
    try:
        assert side.obs.install_flight_recorder() == p
    finally:
        side.obs.uninstall_flight_recorder()
        side.pkg.set_flags(old)


@pytest.mark.parametrize("name", SIDES)
def test_manual_dump_flight(tmp_path, name):
    side = PKGS[name]
    side.obs.enable()
    side.obs.emit("instant", "before_dump")
    p = str(tmp_path / "manual.json")
    assert side.obs.dump_flight(path=p, reason="manual-test") == p
    box = json.load(open(p))
    assert box["reason"] == "manual-test" and box["exception"] is None
    assert any(e["name"] == "before_dump" for e in box["events"])


def test_flight_recorder_chains_to_the_serve_drain_handler(tmp_path):
    """SIGTERM with the recorder over the ``serve`` CLI's drain handler:
    one dump, then the drain's KeyboardInterrupt; uninstalling puts the
    drain handler back."""
    import subprocess
    box = str(tmp_path / "box.json")
    code = f"""
import os, signal, json
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.serving import serve
serve._install_drain_handler()
obs.install_flight_recorder(path={box!r})
try:
    os.kill(os.getpid(), signal.SIGTERM)
    signal.pause()
except KeyboardInterrupt:
    print("DRAINED")
print("DUMP", json.load(open({box!r}))["reason"])
obs.uninstall_flight_recorder()
print("RESTORED", signal.getsignal(signal.SIGTERM) is serve._on_signal)
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["DRAINED", "DUMP", "SIGTERM",
                                  "RESTORED", "True"]


# --------------------------------------------------- SLO monitors --------
def _both_slo(rules, script):
    """Run ``script(side, monitor)`` on both packages over the same rule
    set; returns each side's list of poll statuses (without times)."""
    out = {}
    for name in SIDES:
        side = PKGS[name]
        m = side.obs.install_slo_monitor([side.obs.SLORule(**r)
                                          for r in rules])
        out[name] = [_no_time(st) for st in script(side, m)]
        side.obs.uninstall_slo_monitor()
    assert out["port"] == out["jax"]        # the math agrees exactly
    return out["port"]


@pytest.mark.parametrize("name", SIDES)
def test_slo_rule_validation(name):
    obs = PKGS[name].obs
    for kw in (dict(objective=0.0), dict(objective=1.0, window=0.0),
               dict(objective=1.0, burn_rate=0.0),
               dict(objective=1.0, quantile=1.0),
               dict(objective=1.0, min_count=0),
               dict(objective=1.0, quantile=0.99, per="n")):
        with pytest.raises(ValueError):
            obs.SLORule("m", **kw)
    with pytest.raises(ValueError):
        obs.SLOMonitor([])
    with pytest.raises(ValueError):
        obs.SLOMonitor([obs.SLORule("a", 1.0, name="dup"),
                        obs.SLORule("b", 1.0, name="dup")])
    rules = obs.standard_serving_rules(p99_latency_ms=50.0,
                                       shed_ratio=0.01)
    assert [r.name for r in rules] == ["serving_p99_latency_ms",
                                       "serving_shed_ratio"]


def test_slo_quantile_window_breach_and_recovery():
    def script(side, m):
        side.monitor.stat_reset("slo.t.lat")
        side.monitor.stat_reset("slo.breaches")
        out = [m.poll(now=100.0)]
        for _ in range(4):
            side.monitor.stat_observe("slo.t.lat", 100.0)
        out += [m.poll(now=101.0), m.poll(now=103.0), m.poll(now=109.0)]
        out.append({"breaches": side.monitor.get_stat("slo.breaches"),
                    "status": m.status()["status"]})
        side.monitor.stat_reset("slo.t.lat")
        return out
    sts = _both_slo([dict(metric="slo.t.lat", objective=10.0, window=5.0,
                          quantile=0.5, name="lat")], script)
    assert [s["status"] for s in sts[:4]] == ["ok", "degraded", "degraded",
                                               "ok"]
    assert sts[1]["breached"] == ["lat"] and sts[1]["rules"][0]["burn"] > 1
    assert sts[4] == {"breaches": 1, "status": "ok"}


def test_slo_breach_and_recover_events():
    t = port_obs.enable(capacity=128)
    port_monitor.stat_reset("slo.t.ev")
    m = port_obs.install_slo_monitor([port_obs.SLORule(
        "slo.t.ev", 10.0, window=5.0, quantile=0.5, name="ev")])
    m.poll(now=100.0)
    for _ in range(4):
        port_monitor.stat_observe("slo.t.ev", 100.0)
    m.poll(now=101.0)
    m.poll(now=109.0)
    evs = [e for e in t.events() if e["kind"] == "slo"]
    assert [e["name"] for e in evs] == ["breach", "recover"]
    assert evs[0]["args"]["rule"] == "ev"
    port_monitor.stat_reset("slo.t.ev")


def test_slo_burn_rate_threshold():
    def script(side, m):
        side.monitor.stat_reset("slo.t.burn")
        out = [m.poll(now=10.0)]
        for _ in range(4):
            side.monitor.stat_observe("slo.t.burn", 15.0)
        out.append(m.poll(now=11.0))
        for _ in range(16):
            side.monitor.stat_observe("slo.t.burn", 100.0)
        out.append(m.poll(now=12.0))
        side.monitor.stat_reset("slo.t.burn")
        return out
    sts = _both_slo([dict(metric="slo.t.burn", objective=10.0, window=5.0,
                          quantile=0.5, burn_rate=2.0, name="fast_burn")],
                    script)
    r = sts[1]["rules"][0]
    assert 1.0 < r["burn"] < 2.0 and not r["breached"]
    assert sts[2]["rules"][0]["breached"]


def test_slo_ratio_and_rate_rules():
    def script(side, m):
        mon = side.monitor
        for n in ("slo.t.shed", "slo.t.reqs", "slo.t.evts"):
            mon.stat_reset(n)
        mon.stat_add("slo.t.reqs", 100)
        out = [m.poll(now=0.0)]
        mon.stat_add("slo.t.shed", 5)
        mon.stat_add("slo.t.reqs", 40)
        mon.stat_add("slo.t.evts", 10)
        out.append(m.poll(now=2.0))
        out.append(m.poll(now=4.0))
        mon.stat_add("slo.t.shed", 3)
        out.append(m.poll(now=70.0))
        out.append(m.poll(now=200.0))
        for n in ("slo.t.shed", "slo.t.reqs", "slo.t.evts"):
            mon.stat_reset(n)
        return out
    sts = _both_slo([dict(metric="slo.t.shed", objective=0.10, window=60.0,
                          per="slo.t.reqs", name="shed_ratio"),
                     dict(metric="slo.t.evts", objective=1.0, window=60.0,
                          name="evt_rate")], script)
    ratio, rate = sts[1]["rules"]
    assert ratio["kind"] == "ratio"
    assert ratio["measured"] == pytest.approx(0.125) and ratio["breached"]
    assert rate["kind"] == "rate" and rate["measured"] == pytest.approx(5.0)
    assert sts[3]["rules"][0]["measured"] == "inf"
    json.dumps(sts[3])
    assert sts[4]["status"] == "ok"


@pytest.mark.parametrize("name", SIDES)
def test_slo_status_without_monitor_is_ok(name):
    obs = PKGS[name].obs
    assert obs.get_slo_monitor() is None
    assert obs.slo_status() == {"installed": False, "status": "ok",
                                "rules": [], "breached": [], "reasons": []}


def test_slo_explicit_per_wins_over_histogram_metric():
    def script(side, m):
        for n in ("slo.t.hist_ms", "slo.t.den"):
            side.monitor.stat_reset(n)
        out = [m.poll(now=0.0)]
        for _ in range(4):
            side.monitor.stat_observe("slo.t.hist_ms", 100.0)
        side.monitor.stat_add("slo.t.den", 16)
        out.append(m.poll(now=1.0))
        for n in ("slo.t.hist_ms", "slo.t.den"):
            side.monitor.stat_reset(n)
        return out
    sts = _both_slo([dict(metric="slo.t.hist_ms", objective=0.5,
                          window=60.0, per="slo.t.den",
                          name="hist_ratio")], script)
    r = sts[1]["rules"][0]
    assert r["kind"] == "ratio" and r["measured"] == pytest.approx(0.25)
    assert not r["breached"]


def test_slo_min_count_gates_quantile_windows():
    def script(side, m):
        side.monitor.stat_reset("slo.t.mc_ms")
        out = [m.poll(now=0.0)]
        for _ in range(4):
            side.monitor.stat_observe("slo.t.mc_ms", 100.0)
        out.append(m.poll(now=1.0))
        side.monitor.stat_observe("slo.t.mc_ms", 100.0)
        out.append(m.poll(now=2.0))
        out.append(m.poll(now=200.0))
        out.append({"measured_gauge": side.monitor.get_stat(
            "slo.mc.measured")})
        side.monitor.stat_reset("slo.t.mc_ms")
        return out
    sts = _both_slo([dict(metric="slo.t.mc_ms", objective=1.0, window=60.0,
                          quantile=0.99, min_count=5, name="mc")], script)
    assert sts[1]["rules"][0]["measured"] is None
    assert sts[2]["rules"][0]["breached"]
    assert sts[3]["rules"][0]["measured"] is None
    assert sts[4] == {"measured_gauge": 0}


@pytest.mark.parametrize("name", SIDES)
def test_slo_uninstall_clears_rule_gauges(name):
    side = PKGS[name]
    side.monitor.stat_reset("slo.t.stale")
    m = side.obs.install_slo_monitor([side.obs.SLORule(
        "slo.t.stale", 1.0, window=60.0, name="stale_rate")])
    m.poll(now=0.0)
    side.monitor.stat_add("slo.t.stale", 1000)
    assert m.poll(now=1.0)["rules"][0]["breached"]
    assert side.monitor.get_stat("slo.stale_rate.breached") == 1
    side.obs.uninstall_slo_monitor()
    assert side.monitor.get_stat("slo.stale_rate.breached") == 0
    assert side.monitor.get_stat("slo.degraded") == 0
    side.monitor.stat_reset("slo.t.stale")


# -------------------------------------------------- perf observatory ----
def test_perf_disabled_path_contract():
    """Every observatory site pays one ``obs_hook`` attribute check when
    off, and never imports observability on the hot path (the
    disabled-path checks of ``tools/obs_smoke.py``, on the port)."""
    from paddle_tpu_torch.serving.engine import InferenceEngine
    from paddle_tpu_torch.serving.generation import GenerationEngine
    from paddle_tpu_torch.static.executor import Executor
    assert port_hook.current_perf() is None and not port_obs.perf_enabled()
    assert port_hook.current_perf.__code__.co_names == ("_perf",)
    for fn in (Executor.run, InferenceEngine._execute,
               GenerationEngine._decode_step):
        names = fn.__code__.co_names
        assert "obs_hook" in names and "observability" not in names
    for fn in (InferenceEngine._execute, GenerationEngine._decode_step):
        assert "_export" in fn.__code__.co_names
    run = Executor._run.__code__.co_names
    assert {"obs_hook", "_perf", "_export"} <= set(run)
    assert port_obs.perf_report() == {"enabled": False}
    assert "disabled" in port_obs.render_perf_report()


class _CountingEvent:
    """Stands in for a CUDA timing event: counts records and waits."""

    log = []

    def __init__(self, t):
        self.t = t

    def record(self, stream=None):
        _CountingEvent.log.append("record")

    def synchronize(self):
        _CountingEvent.log.append("synchronize")

    def elapsed_time(self, end):
        _CountingEvent.log.append("elapsed_time")
        return 2.0


def test_perf_waits_only_on_sampled_steps(monkeypatch):
    """Counted synchronisations: a device lane is started and waited for
    on every ``sample_every``-th step only; the steps between make no
    event and wait for nothing."""
    from paddle_tpu_torch.observability import perf as perf_mod
    _CountingEvent.log = []
    real_device_event = perf_mod._device_event
    monkeypatch.setattr(perf_mod, "_device_event",
                        lambda dev: _CountingEvent(0))
    monkeypatch.setattr(perf_mod._Sample, "stop",
                        lambda self: setattr(self, "end",
                                             self.end or _CountingEvent(1)))
    p = port_obs.enable_perf(sample_every=3, memory=False)
    waits = []
    for step in range(1, 10):
        before = list(_CountingEvent.log)
        s = p.begin("executor", "ident", "cuda")
        assert (s is not None) == (step % 3 == 0)
        p.step("executor", "ident", 0.0, 0.001, 0.0, 0.001, None,
               sample=s)
        new = _CountingEvent.log[len(before):]
        waits.append(new.count("synchronize"))
    assert waits == [0, 0, 1, 0, 0, 1, 0, 0, 1]
    rep = p.report()["identities"][0]
    assert rep["sampled"] == 3
    assert rep["measured"]["step_ms_p50"] == pytest.approx(2.0)
    # serving: the sample's end is read after the engine's own host
    # read, so the observatory never waits itself
    _CountingEvent.log = []
    for step in range(1, 7):
        s = p.serving_begin("e", "dispatch", "cuda")
        if s is not None:
            s.stop()
        p.serving_step("e", "dispatch", 0.01, s)
    assert _CountingEvent.log.count("synchronize") == 0
    an = p.report()["serving"]["e.dispatch"]
    assert an["steps"] == 6 and an["sampled"] == 2
    assert an["device_ms_p50"] == pytest.approx(2.0)
    # off the card, no event is ever made
    import torch
    assert real_device_event("cpu") is None
    assert real_device_event(torch.device("cpu")) is None


def test_perf_sampling_is_decided_once_in_begin(monkeypatch):
    """Two threads on one identity: the step whose ``begin`` was not
    sampled records no device lane even when another thread's step
    moved the count onto a sampled one, and the sampled ``begin``'s
    step records the events' time."""
    from paddle_tpu_torch.observability import perf as perf_mod
    _CountingEvent.log = []
    monkeypatch.setattr(perf_mod, "_device_event",
                        lambda dev: _CountingEvent(0))
    monkeypatch.setattr(perf_mod._Sample, "stop",
                        lambda self: setattr(self, "end",
                                             self.end or _CountingEvent(1)))
    port_monitor.stat_reset("step.device_ms")
    p = port_obs.enable_perf(sample_every=2, memory=False)
    a = p.begin("executor", "ident", "cuda")        # step 1: unsampled
    b = p.begin("executor", "ident", "cuda")        # step 1 again
    assert a is None and b is None
    p.step("executor", "ident", 0.0, 0.001, 0.0, 0.001, None, sample=b)
    # the count now says step 2 is next, but ``a`` was not sampled
    p.step("executor", "ident", 0.0, 0.001, 0.0, 0.001, None, sample=a)
    assert _CountingEvent.log.count("synchronize") == 0
    assert port_monitor.histogram_summary("step.device_ms")["count"] == 0
    c = p.begin("executor", "ident", "cuda")        # step 3: unsampled
    d = p.begin("executor", "ident", "cpu")         # unsampled as well
    assert c is None and d is None
    p.step("executor", "ident", 0.0, 0.001, 0.0, 0.001, None, sample=c)
    e = p.begin("executor", "ident", "cuda")        # step 4: sampled
    assert e is not None
    p.step("executor", "ident", 0.0, 0.001, 0.0, 0.001, None, sample=e)
    assert _CountingEvent.log.count("synchronize") == 1
    rep = p.report()["identities"][0]
    assert rep["steps"] == 4 and rep["sampled"] == 1
    assert rep["measured"]["step_ms_p50"] == pytest.approx(2.0)


def test_perf_step_anatomy_from_executor():
    t = port_obs.enable(capacity=512)
    port_obs.enable_perf(sample_every=2)
    port_monitor.stat_reset("perf.fences")
    side = PKGS["port"]

    def run():
        main, loss = _static_mlp(side)
        exe = side.pkg.static.Executor()
        for _ in range(5):
            exe.run(main, feed=_feed(8), fetch_list=[loss])
        exe.close()
    _static(side, run)
    rep = port_obs.perf_report()
    assert rep["enabled"] and rep["sample_every"] == 2
    [r0] = [r for r in rep["identities"] if r["component"] == "executor"]
    # the building run is left out: 4 measured steps, sampled at 2 and 4
    assert r0["steps"] == 4 and r0["sampled"] == 2
    assert r0["host_ms_mean"] > 0 and r0["measured"]["step_ms_p50"] > 0
    assert r0["predicted"]["peak_bytes"] > 0
    assert np.isfinite(r0["drift"]["step_time_pct"])
    assert port_monitor.histogram_summary("step.host_ms")["count"] >= 4
    assert port_monitor.histogram_summary("step.device_ms")["count"] >= 2
    assert port_monitor.get_stat("perf.fences") == 2
    names = {e["name"] for e in t.events() if e["kind"] == "perf"}
    assert {"step.host.feed", "step.host.dispatch", "step.device"} <= names
    assert "executor#" in port_obs.render_perf_report()
    # no card: no device memory to read (ROADMAP §C)
    import torch
    if not torch.cuda.is_available():
        assert port_obs.device_memory() == {}


def test_perf_identity_split_per_feed_signature():
    got = {}
    for name in SIDES:
        side = PKGS[name]
        side.obs.enable_perf(sample_every=0)

        def run():
            main, loss = _static_mlp(side)
            exe = side.pkg.static.Executor()
            for n in (4, 16):
                for _ in range(3):
                    exe.run(main, feed=_feed(n), fetch_list=[loss])
            exe.close()
        _static(side, run)
        idents = [r for r in side.obs.perf_report()["identities"]
                  if r["component"] == "executor"]
        got[name] = sorted((str(r["identity"]).split("#")[0].split("[")[1],
                            r["steps"]) for r in idents)
    assert got["port"] == [("16x8;16x1]", 2), ("4x8;4x1]", 2)]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("name", SIDES)
def test_drift_math_hand_computed(name):
    perf_mod = sys.modules[PKGS[name].obs.__name__ + ".perf"]
    idp = perf_mod._IdentityPerf("executor", 7)
    idp.steps, idp.sampled, idp.host_sum_s = 10, 3, 0.05
    idp.device_s.extend([0.002, 0.004, 0.003])
    idp.peak_bytes = 1500
    idp.predicted = {"predicted_step_s": 0.002, "peak_bytes": 1000}
    d = idp.drift()
    assert d["host_ms_mean"] == pytest.approx(5.0)
    assert d["measured"]["step_ms_p50"] == pytest.approx(3.0)
    assert d["drift"]["step_time_pct"] == pytest.approx(50.0)
    assert d["drift"]["peak_bytes_pct"] == pytest.approx(50.0)
    idp.predicted = {"predicted_step_s": 0.002, "peak_bytes": 4000,
                     "peak_bytes_per_shard": 750}
    assert idp.drift()["drift"]["peak_bytes_pct"] == pytest.approx(100.0)
    idp.predicted = None
    assert idp.drift()["drift"] == {}


def test_predicted_step_priced_on_the_cpu_row():
    from paddle_tpu_torch.observability.perf import _predicted_step_s
    from paddle_tpu_torch.static.analysis.cost import CHIP_SPECS
    old = paddle_tpu_torch.get_flags(["perf_chip"])
    paddle_tpu_torch.set_flags({"perf_chip": "cpu"})
    try:
        spec = CHIP_SPECS["cpu"]
        assert _predicted_step_s({"flops": spec.peak_flops,
                                  "min_traffic_bytes": 0}) == \
            pytest.approx(1.0)
    finally:
        paddle_tpu_torch.set_flags(old)


def test_resolve_perf_chip_warns_on_unknown_flag():
    from paddle_tpu_torch.static.analysis.cost import resolve_perf_chip
    old = paddle_tpu_torch.get_flags(["perf_chip"])
    try:
        paddle_tpu_torch.set_flags({"perf_chip": "v5"})
        with pytest.warns(RuntimeWarning, match="perf_chip"):
            chip = resolve_perf_chip("cpu")
        assert chip == "cpu"
    finally:
        paddle_tpu_torch.set_flags(old)


@pytest.mark.parametrize("name", SIDES)
def test_perf_identity_lru_cap(name):
    side = PKGS[name]
    perf_mod = sys.modules[side.obs.__name__ + ".perf"]
    p = side.obs.enable_perf(sample_every=0)
    for i in range(perf_mod._MAX_IDENTITIES + 10):
        p.step("executor", f"id{i}", 0.0, 0.0, 0.0, 0.0, None)
    t = p.report()["totals"]
    assert t["identities"] == perf_mod._MAX_IDENTITIES
    assert t["identities_evicted"] == 10


@pytest.mark.parametrize("name", SIDES)
def test_serving_step_histogram_mirrors_per_engine(name):
    side = PKGS[name]
    p = side.obs.enable_perf(sample_every=0)
    for n in ("perf.serving.dispatch_ms", "perf.serving.bert.dispatch_ms"):
        side.monitor.stat_reset(n)
    p.serving_step("bert", "dispatch", 0.01)
    p.serving_step(None, "dispatch", 0.02)
    assert side.monitor.histogram_summary(
        "perf.serving.dispatch_ms")["count"] == 2
    assert side.monitor.histogram_summary(
        "perf.serving.bert.dispatch_ms")["count"] == 1
    for n in ("perf.serving.dispatch_ms", "perf.serving.bert.dispatch_ms"):
        side.monitor.stat_reset(n)
