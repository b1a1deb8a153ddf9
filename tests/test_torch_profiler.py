"""``profiler`` held to paddle_tpu's on the CPU: the cases of
``tests/test_profiler.py`` on both packages, and the three
``RecordEvent`` cases of ``tests/test_observability.py``
(``test_record_event_end_without_begin_is_noop``,
``test_record_event_exception_safe_and_nested_under_tracer`` and the
``RecordEvent`` half of ``test_tracer_records_ops_and_spans_with_
nesting``).

Both packages count the same eager ops under the same paddle names for
the same loop (host times differ, and are only held to be >= 0).

Kept difference: ``Profiler(trace_dir=...)`` writes a
``torch.profiler`` Chrome trace (``*.pt.trace.json``) where paddle_tpu
writes a ``jax.profiler`` trace."""
import json
import os
import types

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import observability as jobs
from paddle_tpu import profiler as jprof

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.core import placement

SIDES = {
    "jax": types.SimpleNamespace(pkg=jpaddle, prof=jprof, obs=jobs),
    "torch": types.SimpleNamespace(pkg=tpaddle, prof=tprof, obs=tobs),
}


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)
    for s in SIDES.values():
        s.obs.disable()


def _net(P):
    P.seed(0)
    model = P.nn.Sequential(P.nn.Linear(4, 16), P.nn.ReLU(),
                            P.nn.Linear(16, 1))
    opt = P.optimizer.SGD(learning_rate=0.01, parameters=model.parameters())
    return model, opt


def _steps(P, model, opt, n=3):
    r = np.random.RandomState(0)
    x = P.to_tensor(r.randn(8, 4).astype(np.float32))
    y = P.to_tensor(r.randn(8, 1).astype(np.float32))
    for _ in range(n):
        loss = P.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()


@pytest.mark.parametrize("name", SIDES)
def test_profiler_collects_op_stats_and_summary(name):
    s = SIDES[name]
    model, opt = _net(s.pkg)
    p = s.prof.Profiler(timer_only=True)
    p.start()
    with s.prof.RecordEvent("train_phase"):
        _steps(s.pkg, model, opt)
    p.stop()
    ops = dict((n, c) for n, c, _ in p.key_averages())
    assert ops.get("linear", 0) >= 6  # 2 linears x 3 steps
    assert "relu" in ops
    assert all(ms >= 0 for _, _, ms in p.key_averages())
    text = p.summary(top_k=5)
    assert "train_phase" in text and "linear" in text


def test_both_packages_count_the_same_ops():
    counts = {}
    for name, s in SIDES.items():
        model, opt = _net(s.pkg)
        with s.prof.Profiler(timer_only=True) as p:
            _steps(s.pkg, model, opt, n=2)
        counts[name] = {n: c for n, c, _ in p.key_averages()}
    shared = set(counts["jax"]) & set(counts["torch"])
    assert {"linear", "relu", "mse_loss"} <= shared
    for op in shared:
        assert counts["torch"][op] == counts["jax"][op], op


@pytest.mark.parametrize("name", SIDES)
def test_profiler_off_means_no_collection(name):
    s = SIDES[name]
    model, opt = _net(s.pkg)
    p = s.prof.Profiler(timer_only=True)
    _steps(s.pkg, model, opt)          # not started: nothing recorded
    assert p.key_averages() == []


@pytest.mark.parametrize("name", SIDES)
def test_profiler_step_spans(name):
    s = SIDES[name]
    model, opt = _net(s.pkg)
    with s.prof.Profiler(timer_only=True) as p:
        for _ in range(3):
            p.step()
            _steps(s.pkg, model, opt, n=1)
    spans = [n for n in p._span_stats if n.startswith("ProfileStep#")]
    assert len(spans) == 3


@pytest.mark.parametrize("name", SIDES)
def test_legacy_fluid_profiler_api(name, tmp_path):
    s = SIDES[name]
    model, opt = _net(s.pkg)
    out = str(tmp_path / "prof.txt")
    with s.prof.profiler_guard(profile_path=out):
        _steps(s.pkg, model, opt, n=2)
    assert "linear" in open(out).read()


def test_record_event_nests_without_profiler():
    for s in SIDES.values():
        with s.prof.RecordEvent("outer"):
            with s.prof.RecordEvent("inner"):
                pass


def test_trace_dir_capture_writes_a_chrome_trace(tmp_path):
    """Profiler(trace_dir=...) around a TrainStep leaves a non-empty
    Chrome trace beside the host span stats, and the trace shows the
    ``RecordEvent`` range and the step's ops."""
    P = tpaddle
    P.seed(0)
    net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.Linear(16, 4))
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    step = P.jit.TrainStep(net, lambda o, l: P.nn.functional.cross_entropy(
        o, l), opt)
    rs = np.random.RandomState(0)
    x = P.to_tensor(rs.randn(16, 8).astype("float32"))
    y = P.to_tensor(rs.randint(0, 4, 16).astype("int64"))
    step(x, y)
    trace_dir = str(tmp_path / "trace")
    p = tprof.Profiler(on_trace_ready=tprof.export_chrome_tracing(trace_dir))
    p.start()
    with tprof.RecordEvent("capture_step"):
        loss = step(x, y)
    float(loss)
    p.stop()
    assert p._span_stats["capture_step"][0] == 1
    files = os.listdir(trace_dir)
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    assert p.trace_path == os.path.join(trace_dir, files[0])
    names = {e.get("name") for e in json.load(open(p.trace_path))[
        "traceEvents"]}
    assert "capture_step" in names
    assert any(str(n).startswith("aten::") for n in names)
    assert p.device_table() == []     # no card: no device rows
    with pytest.raises(NotImplementedError):
        tprof.load_profiler_result(p.trace_path)


@pytest.mark.parametrize("name", SIDES)
def test_profiler_sync_ops_mode(name):
    """Opt-in sync mode: stats still collected; the flag seeds the
    default."""
    s = SIDES[name]
    model, opt = _net(s.pkg)
    assert s.prof.Profiler(timer_only=True)._sync_ops is False
    with s.prof.Profiler(timer_only=True, sync_ops=True) as p:
        _steps(s.pkg, model, opt)
    ops = dict((n, c) for n, c, _ in p.key_averages())
    assert ops.get("linear", 0) >= 6
    s.pkg.set_flags({"FLAGS_profiler_sync_ops": True})
    try:
        assert s.prof.Profiler(timer_only=True)._sync_ops is True
    finally:
        s.pkg.set_flags({"FLAGS_profiler_sync_ops": False})


# -- the RecordEvent cases of tests/test_observability.py -----------------

@pytest.mark.parametrize("name", SIDES)
def test_tracer_records_ops_and_record_event_spans_with_nesting(name):
    s = SIDES[name]
    t = s.obs.enable(capacity=256)
    x = s.pkg.to_tensor(np.ones((2, 3), np.float32))
    _ = s.pkg.nn.functional.relu(x * 2.0)
    with s.prof.RecordEvent("outer"):
        with s.prof.RecordEvent("inner"):
            pass
    evs = t.events()
    kinds = {e["kind"] for e in evs}
    assert "op" in kinds and "span" in kinds
    spans = {e["name"]: e for e in evs if e["kind"] == "span"}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["outer"].get("parent") is None
    assert all(e["dur"] >= 0 for e in evs if e["kind"] == "op")


@pytest.mark.parametrize("name", SIDES)
def test_record_event_end_without_begin_is_noop(name):
    r = SIDES[name].prof.RecordEvent("never")
    r.end()
    r.end()                     # idempotent too


@pytest.mark.parametrize("name", SIDES)
def test_record_event_exception_safe_and_nested_under_tracer(name):
    s = SIDES[name]
    t = s.obs.enable()
    with pytest.raises(ValueError):
        with s.prof.RecordEvent("outer"):
            with s.prof.RecordEvent("inner"):
                raise ValueError("boom")
    spans = {e["name"]: e for e in t.events() if e["kind"] == "span"}
    # both spans closed despite the raise, nesting preserved
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    ev = s.prof.RecordEvent("twice").begin()
    ev.end()
    ev.end()                    # second end is a no-op
    assert len([e for e in t.events() if e["name"] == "twice"]) == 1
