"""paddle_tpu_torch's fleet observatory: the twins of
``tests/test_fleet.py`` — per-process telemetry spooling, the
aggregator's merged snapshot, Prometheus text and chrome trace, trace
ids over HTTP, the assembled request trace and the ``/admin`` fleet
surface.

The spool cases run on both packages (the same checksummed documents;
a spool either package writes is read by the other).  The server cases
run on the port's ``ServingServer`` over its ``GenerationEngine``.
Unlike the JAX package's file, nothing here waits a fixed time: the
reconnect case restarts the replica when the client's fresh connection
has failed (an event), and the span that lands after a streamed
response is waited for by a poll with a deadline.
"""
import http.client
import json
import os
import re
import threading
import time
import types
from urllib.parse import urlparse

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import observability as jax_obs
from paddle_tpu.core import obs_hook as jax_hook
from paddle_tpu.observability import export as jax_export
from paddle_tpu.observability import fleet as jax_fleet
from paddle_tpu.utils import monitor as jax_monitor
from paddle_tpu_torch import observability as port_obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.core import obs_hook as port_hook
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.observability import export as port_export
from paddle_tpu_torch.observability import fleet as port_fleet
from paddle_tpu_torch.testing.chaos import make_dyadic_lm
from paddle_tpu_torch.utils import monitor as port_monitor

PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+naif]+$")
PKGS = {
    "jax": types.SimpleNamespace(pkg=paddle_tpu, obs=jax_obs, hook=jax_hook,
                                 export=jax_export, fleet=jax_fleet,
                                 monitor=jax_monitor, build_key="jax"),
    "port": types.SimpleNamespace(pkg=paddle_tpu_torch, obs=port_obs,
                                  hook=port_hook, export=port_export,
                                  fleet=port_fleet, monitor=port_monitor,
                                  build_key="torch"),
}
SIDES = sorted(PKGS)


@pytest.fixture(autouse=True)
def _cpu_and_clean():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield
    for side in PKGS.values():
        side.export.uninstall_exporter()
        side.obs.disable()
    placement.set_default(prev)


def _spool_flags(side, d):
    old = side.pkg.get_flags(["obs_spool_dir", "obs_role",
                              "obs_export_interval_s"])
    side.pkg.set_flags({"obs_spool_dir": d, "obs_role": "t",
                        "obs_export_interval_s": 60.0})
    return old


@pytest.fixture
def spool(tmp_path):
    """Both packages' exporter flags on, pointing at one tmp spool a
    package; everything restored on the way out."""
    dirs = {name: str(tmp_path / f"spool_{name}") for name in SIDES}
    olds = {name: _spool_flags(PKGS[name], d) for name, d in dirs.items()}
    yield dirs
    for name, side in PKGS.items():
        side.export.uninstall_exporter()
        side.pkg.set_flags(olds[name])
        side.obs.disable()


# ------------------------------------------------- checksummed spool --
@pytest.mark.parametrize("name", SIDES)
def test_checksum_roundtrip_and_corruption(name):
    ex = PKGS[name].export
    body = {"role": "r", "pid": 1, "nested": {"a": [1, 2]}}
    data = ex.checksum_wrap(body)
    assert ex.checksum_unwrap(data) == body
    doc = json.loads(data)
    doc["body"]["pid"] = 2
    with pytest.raises(ValueError, match="checksum mismatch"):
        ex.checksum_unwrap(json.dumps(doc).encode())
    with pytest.raises(ValueError):
        ex.checksum_unwrap(b'{"no": "digest"}')


def test_checksummed_documents_are_the_same_bytes():
    body = {"role": "r", "pid": 7, "x": [1.5, "a", None]}
    assert port_export.checksum_wrap(body) == jax_export.checksum_wrap(body)


@pytest.mark.parametrize("name", SIDES)
def test_exporter_spools_and_read_spool_roundtrip(spool, name):
    side = PKGS[name]
    exp = side.export.install_exporter()
    assert exp is side.hook._export and exp.role == "t"
    trc = side.hook._tracer
    tid = "trace0001"
    trc.set_trace(tid)
    sid = trc.begin_span("unit.work", trace=tid)
    side.monitor.stat_add("fleet_test.requests", 5)
    trc.end_span(sid)
    trc.clear_trace()
    assert exp.flush()
    procs = side.fleet.read_spool(spool[name])
    assert [p["label"] for p in procs] == [f"t-{os.getpid()}"]
    p = procs[0]
    assert p["role"] == "t" and p["pid"] == os.getpid()
    assert p["corrupt"] == 0 and p["segments"] >= 1
    assert p["meta"]["build"][side.build_key]
    assert p["metrics"]["stats"]["fleet_test.requests"] >= 5
    spans = [e for e in p["events"] if e.get("name") == "unit.work"]
    assert spans and spans[0]["trace"] == tid
    assert spans[0]["time"] == pytest.approx(time.time(), abs=120)


def test_one_package_reads_the_others_spool(spool):
    """The port's spool read by paddle_tpu's aggregator and the other
    way round: one document format."""
    for writer, reader in (("port", "jax"), ("jax", "port")):
        side = PKGS[writer]
        exp = side.export.install_exporter(role=f"w{writer}")
        side.hook._tracer.emit("unit", f"from_{writer}")
        assert exp.flush()
        side.export.uninstall_exporter()
        [p] = [p for p in PKGS[reader].fleet.read_spool(spool[writer])
               if p["role"] == f"w{writer}"]
        assert p["corrupt"] == 0
        assert any(e["name"] == f"from_{writer}" for e in p["events"])


@pytest.mark.parametrize("name", SIDES)
def test_read_spool_flags_corrupt_documents_without_raising(spool, name):
    side = PKGS[name]
    exp = side.export.install_exporter()
    side.hook._tracer.emit("unit", "e1")
    assert exp.flush()
    [p] = side.fleet.read_spool(spool[name])
    seg = next(f for f in os.listdir(p["dir"]) if f.startswith("trace-"))
    path = os.path.join(p["dir"], seg)
    raw = json.loads(open(path).read())
    raw["body"]["events"] = []
    open(path, "w").write(json.dumps(raw))
    [p2] = side.fleet.read_spool(spool[name])
    assert p2["corrupt"] == 1 and not p2["events"]


@pytest.mark.parametrize("name", SIDES)
def test_fleet_snapshot_and_prometheus_proc_labels(spool, name):
    side = PKGS[name]
    exp = side.export.install_exporter()
    side.monitor.stat_add("fleet_test.gauge", 2)
    exp.flush()
    snap = side.fleet.fleet_snapshot(spool[name], include_self=False)
    assert set(snap["procs"]) == {f"t-{os.getpid()}"}
    assert snap["build_skew"] == []
    text = side.fleet.fleet_prometheus_text(spool[name], include_self=False)
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    assert lines
    assert not [ln for ln in lines if not PROM_LINE.match(ln)]
    assert not [ln for ln in lines if 'proc="' not in ln]
    assert f'proc="t-{os.getpid()}"' in text


def test_build_skew_between_the_packages_is_flagged(spool):
    """A fleet of one paddle_tpu and one port process runs two builds:
    the snapshot names the skew."""
    for name in SIDES:
        exp = PKGS[name].export.install_exporter(role=name)
        exp.flush()
        PKGS[name].export.uninstall_exporter()
    procs = (port_fleet.read_spool(spool["port"])
             + port_fleet.read_spool(spool["jax"]))
    snap = port_fleet.fleet_snapshot(procs=procs)
    assert len(snap["build_skew"]) == 2


@pytest.mark.parametrize("name", SIDES)
def test_merged_chrome_trace_names_one_lane_per_process(spool, name):
    side = PKGS[name]
    exp_a = side.export.install_exporter(role="a")
    side.hook._tracer.emit("unit", "from_a")
    exp_a.flush()
    exp_b = side.export.install_exporter(role="b")
    side.hook._tracer.emit("unit", "from_b")
    exp_b.flush()
    merged = side.fleet.merged_chrome_trace(spool[name], include_self=False)
    evs = merged["traceEvents"]
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    pid = os.getpid()
    assert {f"a-{pid}", f"b-{pid}"} <= names
    assert all(e["ts"] >= 0 for e in evs if e["ph"] != "M")


def test_collect_fleet_bundle(spool, tmp_path):
    exp = port_export.install_exporter()
    port_hook._tracer.emit("unit", "e")
    exp.flush()
    dest = port_fleet.collect_fleet_bundle(str(tmp_path / "bundle"),
                                           reason="test",
                                           extra={"k": 1})
    man = json.load(open(os.path.join(dest, "bundle.json")))
    assert man["reason"] == "test" and man["extra"] == {"k": 1}
    assert man["collected"] == [f"t-{os.getpid()}"] and not man["errors"]
    for f in ("merged_trace.json", "fleet_snapshot.json"):
        json.load(open(os.path.join(dest, f)))
    # a bundle parked in the spool is a copy, not a process
    port_fleet.collect_fleet_bundle(os.path.join(spool["port"], "incident"))
    assert [p["label"] for p in port_fleet.read_spool(spool["port"])] == [
        f"t-{os.getpid()}"]


def test_exporter_installs_at_import_with_the_flag(tmp_path):
    import subprocess
    import sys
    d = str(tmp_path / "spool")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, FLAGS_obs_spool_dir=d, FLAGS_obs_role="child")
    code = ("import os, paddle_tpu_torch\n"
            "from paddle_tpu_torch.core import obs_hook\n"
            "print(obs_hook._export is not None, obs_hook._tracer is not "
            "None, os.getpid())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    on, tracing, pid = out.stdout.split()
    assert on == "True" and tracing == "True"
    [p] = port_fleet.read_spool(d)
    assert p["label"] == f"child-{pid}" and p["metrics"] is not None


# --------------------------------------- distributed request tracing --
@pytest.fixture(scope="module")
def gen_server():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    eng = serving.GenerationEngine(make_dyadic_lm(), num_slots=2,
                                   page_size=4, max_context=32)
    srv = serving.ServingServer(None, port=0, generation=eng).start()
    yield srv
    srv.close()
    eng.close()
    placement.set_default(prev)


def _raw_generate(srv, headers):
    u = urlparse(srv.url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        body = json.dumps({"prompt": [1, 2], "max_new_tokens": 2})
        conn.request("POST", "/generate", body=body, headers=dict(
            {"Content-Type": "application/json"}, **headers))
        r = conn.getresponse()
        raw = r.read().decode()
        last = json.loads(raw.strip().splitlines()[-1]) if raw else {}
        return r.status, dict(r.getheaders()), last
    finally:
        conn.close()


def _events_until(tracer, pred, deadline_s=10.0):
    """The tracer's events once ``pred(events)`` holds (a poll with a
    deadline), or the last snapshot."""
    deadline = time.monotonic() + deadline_s
    while True:
        evs = tracer.events()
        if pred(evs) or time.monotonic() > deadline:
            return evs
        time.sleep(0.01)


def test_server_adopts_wellformed_trace_id(gen_server):
    tracer = port_obs.enable(capacity=4096)
    status, hdrs, _ = _raw_generate(
        gen_server, {"X-Trace-Id": "req-abc.1", "X-Parent-Span": "7"})
    assert status == 200 and hdrs.get("X-Trace-Id") == "req-abc.1"
    # the handler's root span lands just after the last chunk is written
    evs = [e for e in _events_until(tracer, lambda evs: any(
        e["name"] == "http.generate" and e.get("trace") == "req-abc.1"
        for e in evs)) if e.get("trace") == "req-abc.1"]
    assert "http.generate" in {e["name"] for e in evs}
    assert any(e.get("remote_parent") == "7" for e in evs)


@pytest.mark.parametrize("bad", [
    "spaces are bad", "bang!", "", "x" * 65, "-leadingdash",
    "unicodeé", '"quoted"'])
def test_malformed_trace_id_gets_fresh_id_never_500(gen_server, bad):
    status, hdrs, _ = _raw_generate(gen_server, {"X-Trace-Id": bad})
    assert status == 200
    echoed = hdrs.get("X-Trace-Id")
    assert echoed and echoed != bad
    assert re.fullmatch(r"[0-9a-f]{32}", echoed)


def test_oversized_parent_span_ignored_not_500(gen_server):
    status, hdrs, _ = _raw_generate(
        gen_server, {"X-Trace-Id": "ok-id", "X-Parent-Span": "not-int"})
    assert status == 200 and hdrs.get("X-Trace-Id") == "ok-id"


def test_client_stamps_and_reports_trace_ids(gen_server):
    client = serving.Client(gen_server.url)
    assert client.last_trace_id is None
    client.generate([1, 2], max_new_tokens=2)
    first = client.last_trace_id
    assert first and re.fullmatch(r"[0-9a-f]{32}", first)
    client.generate([1, 2], max_new_tokens=2)
    assert client.last_trace_id != first
    pinned = serving.Client(gen_server.url, trace_id="pin-1")
    pinned.generate([1, 2], max_new_tokens=2)
    pinned.generate([1, 3], max_new_tokens=2)
    assert pinned.last_trace_id == "pin-1"
    client.close()
    pinned.close()


def test_trace_context_survives_reconnect_retry():
    """The retry loop replays the SAME X-Trace-Id.  The replica comes
    back when the client's fresh connection has failed (its second
    dropped connection), inside the client's backoff."""
    tracer = port_obs.enable(capacity=4096)
    eng = serving.GenerationEngine(make_dyadic_lm(), num_slots=2,
                                   page_size=4, max_context=32)
    srv = serving.ServingServer(None, port=0, generation=eng).start()
    port = srv.port
    srv.close()                         # the replica goes down
    client = serving.Client(f"http://127.0.0.1:{port}",
                            trace_id="retry-trace")
    client.reconnect_backoff_s = 2.0
    failed_fresh = threading.Event()
    drops = [0]
    drop = client._drop_conn

    def counting_drop():
        drops[0] += 1
        if drops[0] == 2:
            failed_fresh.set()
        drop()
    client._drop_conn = counting_drop
    box = {}

    def restart():
        if failed_fresh.wait(60):
            box["srv"] = serving.ServingServer(None, port=port,
                                               generation=eng).start()

    t = threading.Thread(target=restart)
    t.start()
    try:
        out = client.generate([1, 2], max_new_tokens=2)
        assert isinstance(out, list) and client.reconnects >= 1
        assert client.last_trace_id == "retry-trace"
        evs = _events_until(tracer, lambda evs: {
            "client.generate", "http.generate"} <= {
            e["name"] for e in evs if e.get("trace") == "retry-trace"})
        assert {"client.generate", "http.generate"} <= {
            e["name"] for e in evs if e.get("trace") == "retry-trace"}
    finally:
        failed_fresh.set()
        t.join()
        if "srv" in box:
            box["srv"].close()
        client.close()
        eng.close()


def test_assemble_trace_connects_client_and_server_spans(spool):
    exp = port_export.install_exporter()
    eng = serving.GenerationEngine(make_dyadic_lm(), num_slots=2,
                                   page_size=4, max_context=32)
    srv = serving.ServingServer(None, port=0, generation=eng).start()
    try:
        client = serving.Client(srv.url, trace_id="asm-1")
        client.generate([1, 2], max_new_tokens=2)
        client.close()
        _events_until(port_hook._tracer, lambda evs: any(
            e["name"] == "http.generate" for e in evs))
        exp.flush()
        asm = port_fleet.assemble_trace(
            port_fleet.read_spool(spool["port"]), "asm-1")
        assert asm["connected"] and asm["components"] == 1
        assert asm["events"] >= 3
        assert {"client.generate", "http.generate"} <= set(asm["names"])
    finally:
        srv.close()
        eng.close()


def test_assemble_trace_over_predict_reaches_the_engine_batch(tmp_path):
    """``/predict``: the client's span, the handler's, the engine's
    enqueue and its batch's dispatch form one connected trace."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.testing.chaos import make_dyadic_model
    tracer = port_obs.enable(capacity=4096)
    model = make_dyadic_model()
    prefix = str(tmp_path / "m")
    jit.save(model, prefix, input_spec=[jit.InputSpec([None, 8],
                                                      "float32")])
    from paddle_tpu_torch import inference
    eng = serving.InferenceEngine(
        inference.create_predictor(inference.Config(prefix)),
        max_batch_size=4, batch_timeout_ms=1.0)
    eng.warmup()
    srv = serving.ServingServer(eng, port=0).start()
    try:
        client = serving.Client(srv.url, trace_id="pred-1")
        client.predict(np.ones((2, 8), np.float32) / 4)
        client.close()
        _events_until(tracer, lambda evs: any(
            e["name"] == "http.predict" for e in evs))
        me = port_fleet._merge_self([])
        asm = port_fleet.assemble_trace(me, "pred-1")
        assert asm["connected"]
        assert {"client.predict", "http.predict", "enqueue",
                "dispatch"} <= set(asm["names"])
    finally:
        srv.close()
        eng.close()


# ------------------------------------------------------ admin surface --
def test_admin_fleet_aggregates_two_replicas(gen_server):
    eng_b = serving.GenerationEngine(make_dyadic_lm(seed=11), num_slots=2,
                                     page_size=4, max_context=32)
    srv_b = serving.ServingServer(None, port=0, generation=eng_b).start()
    fv = port_fleet.FleetView(timeout_s=5.0)
    fv.register("lm", urls=[gen_server.url, srv_b.url])
    gen_server.attach_fleet(fv)
    try:
        client = serving.Client(gen_server.url)
        snap = client._get_json("/admin/fleet")
        client.close()
        lm = snap["fleet"]["lm"]
        assert lm["count"] == 2 and lm["ready"] == 2
        assert all(r["reachable"] for r in lm["replicas"])
    finally:
        gen_server.attach_fleet(None)
        srv_b.close()
        eng_b.close()


def test_admin_fleet_without_a_view_summarizes_the_spool(gen_server, spool):
    port_export.install_exporter().flush()
    client = serving.Client(gen_server.url)
    snap = client._get_json("/admin/fleet")
    client.close()
    assert snap["fleet"] == {}
    assert snap["spool"]["procs"] == [f"t-{os.getpid()}"]


def test_fleet_view_reports_a_dead_replica_unreachable():
    srv = serving.ServingServer(None, port=0, generation=serving.
                                GenerationEngine(make_dyadic_lm(),
                                                 num_slots=2, page_size=4,
                                                 max_context=32)).start()
    url = srv.url
    srv.close()
    srv._httpd.generation.close()
    fv = port_fleet.FleetView(timeout_s=2.0)
    fv.register("lm", urls=[url])
    lm = fv.snapshot()["fleet"]["lm"]
    assert lm["count"] == 1 and lm["ready"] == 0
    assert lm["replicas"][0]["reachable"] is False


def test_admin_trace_returns_merged_chrome_trace(gen_server, spool):
    exp = port_export.install_exporter()
    client = serving.Client(gen_server.url, trace_id="admin-t")
    client.generate([1, 2], max_new_tokens=2)
    exp.flush()
    trace = json.loads(client._post("/admin/trace?secs=0", b"",
                                    {"Content-Type": "application/json"}))
    client.close()
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]
    u = urlparse(gen_server.url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    try:
        conn.request("POST", "/admin/trace?secs=nope")
        assert conn.getresponse().status == 400
    finally:
        conn.close()
