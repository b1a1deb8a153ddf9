"""paddle_tpu_torch's InferenceEngine, HTTP /predict and monitor held to
paddle_tpu's on the CPU.

The cases of ``tests/test_serving.py`` (the engine's semantics, HTTP,
the readiness split, the client's restart ride-through, SIGTERM during
warm-up, the monitor's histograms) and of ``tests/test_hotswap.py``'s
prewarm mismatch and swap on a closed engine, run on the port.  The
model is ``testing.chaos.make_dyadic_model``'s MLP with paddle_tpu's
weights carried across (``set_state_dict`` from numpy): weights and
inputs are dyadic, so every output is exact, and the same request
stream through both packages' engines gives bitwise the same answers.

Not twinned: ``test_serve_smoke_in_process`` and
``test_serving_chaos_in_process`` (the ``tools/serve_smoke`` and chaos
gates are ROADMAP A7's); the ``serve`` CLI's SIGTERM drain is held here
in a subprocess instead.
"""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.testing.chaos import make_dyadic_model as jax_dyadic_model
from paddle_tpu_torch import inference, jit, nn, serving
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.testing import fault
from paddle_tpu_torch.testing.chaos import make_dyadic_lm, make_dyadic_model
from paddle_tpu_torch.utils import monitor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dyadic_requests(rng, n, in_dim=8, max_rows=4):
    """Inputs that are small dyadic rationals: float accumulation is
    exact, so batched/padded results are bitwise-equal to unbatched."""
    return [(rng.randint(-8, 9, (rng.randint(1, max_rows + 1), in_dim))
             / 4.0).astype(np.float32) for _ in range(n)]


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield
    placement.set_default(prev)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The same dyadic MLP saved by both packages: (jax prefix, port
    prefix)."""
    d = tmp_path_factory.mktemp("serving")
    paddle_tpu.seed(7)
    ref = jax_dyadic_model(in_dim=8, hidden=16, out_dim=4)
    jprefix = os.path.join(str(d), "jax")
    paddle_tpu.jit.save(ref, jprefix, input_spec=[
        paddle_tpu.jit.InputSpec([None, 8], "float32")])
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    try:
        model = make_dyadic_model(in_dim=8, hidden=16, out_dim=4)
        model.set_state_dict({k: np.array(v.numpy())
                              for k, v in ref.state_dict().items()})
        tprefix = os.path.join(str(d), "port")
        jit.save(model, tprefix,
                 input_spec=[jit.InputSpec([None, 8], "float32")])
    finally:
        placement.set_default(prev)
    return jprefix, tprefix


@pytest.fixture(scope="module")
def artifact(artifacts):
    return artifacts[1]


def _engine(prefix, **kw):
    pred = inference.create_predictor(inference.Config(prefix))
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("batch_timeout_ms", 5.0)
    eng = serving.InferenceEngine(pred, **kw)
    eng.warmup()
    return eng, pred


# ------------------------------------------------------------- engine --
def test_batched_equals_unbatched_and_jax_engine_bitwise(artifacts):
    jprefix, tprefix = artifacts
    rng = np.random.RandomState(0)
    reqs = _dyadic_requests(rng, 24)
    outs = {}
    for name, pkg, prefix in (("jax", paddle_tpu, jprefix),
                              ("port", paddle_tpu_torch, tprefix)):
        pred = pkg.inference.create_predictor(pkg.inference.Config(prefix))
        eng = pkg.serving.InferenceEngine(pred, max_batch_size=8,
                                          batch_timeout_ms=5.0)
        try:
            eng.warmup()
            refs = [np.asarray(pred.run([x])[0]) for x in reqs]
            futs = [eng.infer([x]) for x in reqs]   # burst: coalesces
            outs[name] = [f.result(timeout=30)[0] for f in futs]
            for out, ref, x in zip(outs[name], refs, reqs):
                assert out.shape == (x.shape[0], 4)
                np.testing.assert_array_equal(out, ref)
            assert eng.stats()["counters"]["batches"] < len(reqs)
        finally:
            eng.close()
    for a, b in zip(outs["jax"], outs["port"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_zero_recompiles_after_warmup(artifact):
    eng, pred = _engine(artifact)
    try:
        base = pred.num_compiled_variants()
        assert base == len(eng.buckets)
        rng = np.random.RandomState(1)
        futs = [eng.infer([x]) for x in _dyadic_requests(rng, 32)]
        for f in futs:
            f.result(timeout=30)
        assert pred.num_compiled_variants() == base
        st = eng.stats()
        assert st["recompiles_after_warmup"] == 0
        assert st["counters"]["batches"] < 32  # coalescing happened
    finally:
        eng.close()


def test_input_validation(artifact):
    eng, _ = _engine(artifact)
    try:
        with pytest.raises(ValueError, match="leading batch dim"):
            eng.infer([np.float32(1.0)])        # scalar input
        with pytest.raises(ValueError, match="max_batch_size"):
            eng.infer([np.zeros((64, 8), np.float32)])
        with pytest.raises(ValueError, match="expected 1 inputs"):
            eng.infer([np.zeros((2, 8), np.float32)] * 2)
        with pytest.raises(ValueError, match="empty request"):
            eng.infer([np.zeros((0, 8), np.float32)])
    finally:
        eng.close()


def test_mismatched_rest_dims_rejected_at_admission(artifact):
    eng, _ = _engine(artifact)
    try:
        with pytest.raises(ValueError, match="per-row shape"):
            eng.infer([np.ones((2, 9), np.float32)])    # model wants 8
        assert eng.infer_sync([np.ones((2, 8), np.float32)],
                              timeout=30)[0].shape == (2, 4)
    finally:
        eng.close()


def test_dispatcher_survives_execute_crash(artifact):
    eng, _ = _engine(artifact)
    try:
        orig = eng._bucket_for        # called in _execute BEFORE the
        eng._bucket_for = lambda rows: (_ for _ in ()).throw(
            RuntimeError("boom outside retry"))  # dispatch-retry loop
        f = eng.infer([np.ones((1, 8), np.float32)])
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=30)
        eng._bucket_for = orig
        assert eng.infer_sync([np.ones((1, 8), np.float32)],
                              timeout=30)[0].shape == (1, 4)
    finally:
        eng.close()


def test_dict_and_bare_array_inputs(artifact):
    eng, pred = _engine(artifact)
    try:
        x = (np.arange(16).reshape(2, 8) / 4.0).astype(np.float32)
        name = pred.get_input_names()[0]
        a = eng.infer_sync({name: x}, timeout=30)
        b = eng.infer_sync(x, timeout=30)       # bare array = only input
        np.testing.assert_array_equal(a[0], b[0])
    finally:
        eng.close()


def test_deadline_expires_in_queue(artifact):
    eng, _ = _engine(artifact)
    try:
        eng.pause()
        x = np.ones((1, 8), np.float32)
        doomed = eng.infer([x], deadline_ms=1.0)
        ok = eng.infer([x])                     # no deadline: survives
        time.sleep(0.02)
        eng.resume()
        with pytest.raises(serving.DeadlineExceeded):
            doomed.result(timeout=30)
        assert ok.result(timeout=30)[0].shape == (1, 4)
        assert eng.stats()["counters"]["deadline_expired"] == 1
    finally:
        eng.close()


def test_default_deadline(artifact):
    eng, _ = _engine(artifact, default_deadline_ms=1.0)
    try:
        eng.pause()
        f = eng.infer([np.ones((1, 8), np.float32)])
        time.sleep(0.02)
        eng.resume()
        with pytest.raises(serving.DeadlineExceeded):
            f.result(timeout=30)
    finally:
        eng.close()


def test_queue_full_sheds(artifact):
    eng, _ = _engine(artifact, max_queue=4)
    try:
        eng.pause()
        x = np.ones((1, 8), np.float32)
        futs = [eng.infer([x]) for _ in range(4)]
        for _ in range(3):
            with pytest.raises(serving.QueueFull):
                eng.infer([x])
        assert eng.stats()["counters"]["shed"] == 3
        eng.resume()
        for f in futs:                          # accepted ones all serve
            assert f.result(timeout=30)[0].shape == (1, 4)
    finally:
        eng.close()


def test_invalid_buckets_rejected(artifact):
    pred = inference.create_predictor(inference.Config(artifact))
    with pytest.raises(ValueError, match="exceeds max_batch_size"):
        serving.InferenceEngine(pred, max_batch_size=8, buckets=[48])
    with pytest.raises(ValueError, match="positive"):
        serving.InferenceEngine(pred, max_batch_size=8, buckets=[0, 4])


def test_drain_unpauses(artifact):
    eng, _ = _engine(artifact)
    eng.pause()
    f = eng.infer([np.ones((1, 8), np.float32)])
    assert eng.drain(timeout=30)            # must not livelock
    assert f.result(timeout=0)[0].shape == (1, 4)
    eng.close()


def test_expired_slots_do_not_shed_live_traffic(artifact):
    eng, _ = _engine(artifact, max_queue=2)
    gate = threading.Event()
    try:
        orig = eng._pred.run

        def slow_run(feeds):
            gate.wait(10)
            return orig(feeds)
        eng._pred.run = slow_run
        x = np.ones((1, 8), np.float32)
        f1 = eng.infer([x])                 # occupies the dispatcher
        time.sleep(0.1)                     # now blocked inside run()
        dead = [eng.infer([x], deadline_ms=1.0) for _ in range(2)]
        time.sleep(0.02)                    # both queued slots expired
        f4 = eng.infer([x])                 # swept at admission
        eng._pred.run = orig
        gate.set()
        assert f1.result(timeout=30)[0].shape == (1, 4)
        assert f4.result(timeout=30)[0].shape == (1, 4)
        for d in dead:
            with pytest.raises(serving.DeadlineExceeded):
                d.result(timeout=30)
    finally:
        gate.set()
        eng.close()


def test_graceful_drain_and_close(artifact):
    eng, _ = _engine(artifact)
    rng = np.random.RandomState(2)
    futs = [eng.infer([x]) for x in _dyadic_requests(rng, 16)]
    assert eng.drain(timeout=30)
    assert all(f.done() for f in futs)
    with pytest.raises(serving.EngineClosed):
        eng.infer([np.ones((1, 8), np.float32)])    # draining
    eng.close()
    assert eng.stats()["state"] == "closed"
    eng.close()                                     # idempotent


def test_close_never_strands_futures(artifact):
    eng, _ = _engine(artifact)
    eng.pause()
    x = np.ones((2, 8), np.float32)
    futs = [eng.infer([x]) for _ in range(6)]
    eng.close()         # close unpauses, flushes, then stops
    for f in futs:
        assert f.done()
        f.result(timeout=0)


def test_dispatch_fault_is_retried(artifact):
    eng, _ = _engine(artifact, dispatch_retries=2)
    try:
        with fault.inject("serving.dispatch:count=2"):
            out = eng.infer_sync([np.ones((1, 8), np.float32)],
                                 timeout=30)
            assert fault.fire_count("serving.dispatch") == 2
        assert out[0].shape == (1, 4)
        assert eng.stats()["counters"]["dispatch_retries"] == 2
    finally:
        eng.close()


def test_dispatch_retries_exhausted_fails_cleanly(artifact):
    eng, _ = _engine(artifact, dispatch_retries=1)
    try:
        with fault.inject("serving.dispatch"):      # unlimited fires
            assert fault.is_armed()
            f = eng.infer([np.ones((1, 8), np.float32)])
            with pytest.raises(fault.FaultInjected):
                f.result(timeout=30)
        assert not fault.is_armed()
        assert eng.stats()["counters"]["failed"] == 1
        assert eng.infer_sync([np.ones((1, 8), np.float32)],
                              timeout=30)[0].shape == (1, 4)
    finally:
        eng.close()


def test_enqueue_fault_propagates_to_caller(artifact):
    eng, _ = _engine(artifact)
    try:
        with fault.inject("serving.enqueue:count=1"):
            with pytest.raises(fault.FaultInjected):
                eng.infer([np.ones((1, 8), np.float32)])
        assert eng.infer_sync([np.ones((1, 8), np.float32)],
                              timeout=30)[0].shape == (1, 4)
    finally:
        eng.close()


def test_concurrent_clients_engine(artifact):
    """16 client threads (more than this machine's cores) with the
    interpreter switching threads every microsecond: every answer bitwise
    the request's own, and the engine's counters add up."""
    eng, pred = _engine(artifact)
    interval = sys.getswitchinterval()
    try:
        rng = np.random.RandomState(3)
        reqs = _dyadic_requests(rng, 48)
        refs = [np.asarray(pred.run([x])[0]) for x in reqs]
        results = [None] * len(reqs)

        def client(idx):
            for i in range(idx, len(reqs), 16):
                results[i] = eng.infer_sync([reqs[i]], timeout=30)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(16)]
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        for out, ref in zip(results, refs):
            np.testing.assert_array_equal(out[0], ref)
        st = eng.stats()
        c = st["counters"]
        assert c["requests"] == c["responses"] == 48
        assert c["rows"] == sum(x.shape[0] for x in reqs)
        assert st["queue_depth"] == 0 and not st["inflight"]
        assert st["recompiles_after_warmup"] == 0
    finally:
        sys.setswitchinterval(interval)
        eng.close()


def test_fault_rule_actions():
    """The port's fault module: scoped arming that restores the outer
    rules, fire counts, a sleep that returns, an exit with its code, and
    a bad action refused."""
    with fault.inject("a.*:count=1"):
        with fault.inject("b:action=sleep,secs=0.05"):
            t0 = time.monotonic()
            fault.point("b")                    # blocks, then returns
            assert time.monotonic() - t0 >= 0.05
            assert fault.fire_count("b") == 1
            fault.point("a.x")                  # not armed in here
        with pytest.raises(fault.FaultInjected, match="a.x"):
            fault.point("a.x")
        fault.point("a.x")                      # count=1 spent
        assert fault.fire_count() == 1
    assert not fault.is_armed()
    with pytest.raises(ValueError, match="action"):
        fault.arm("x:action=explode")
    r = subprocess.run(
        [sys.executable, "-c",
         "from paddle_tpu_torch.testing import fault\n"
         "fault.arm('die:action=exit,code=7')\n"
         "fault.point('die')\n"
         "print('survived')\n"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 7 and "survived" not in r.stdout


def test_engine_stats_fields_match_jax(artifacts):
    """One 3-row request: the same counters, buckets and occupancy on
    both packages' engines, and the same set of fields."""
    stats = {}
    for name, pkg, prefix in (("jax", paddle_tpu, artifacts[0]),
                              ("port", paddle_tpu_torch, artifacts[1])):
        pred = pkg.inference.create_predictor(pkg.inference.Config(prefix))
        eng = pkg.serving.InferenceEngine(pred, max_batch_size=8,
                                          batch_timeout_ms=5.0)
        try:
            eng.warmup()
            eng.infer_sync([np.ones((3, 8), np.float32)], timeout=30)
            stats[name] = eng.stats()
        finally:
            eng.close()
    st = stats["port"]
    assert st["state"] == "running"
    assert st["buckets"] == [1, 2, 4, 8]
    assert st["counters"]["rows"] == 3
    assert st["counters"]["padded_rows"] == 1   # 3 -> bucket 4
    assert 0 < st["mean_batch_occupancy"] <= 1
    assert st["latency_ms"]["count"] >= 1
    assert st["latency_ms"]["p99"] >= st["latency_ms"]["p50"]
    assert set(st) == set(stats["jax"])
    assert st["counters"] == stats["jax"]["counters"]
    for k in ("buckets", "mean_batch_occupancy", "padding_waste",
              "requests_per_batch", "recompiles_after_warmup"):
        assert st[k] == stats["jax"][k], k


def test_engine_does_not_slice_unbatched_output(tmp_path):
    class TwoHead(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 2)

        def forward(self, x):
            return self.fc(x), paddle_tpu_torch.ones([8, 3])

    paddle_tpu_torch.seed(1)
    prefix = os.path.join(str(tmp_path), "twohead")
    jit.save(TwoHead(), prefix,
             input_spec=[jit.InputSpec([None, 4], "float32")])
    pred = inference.create_predictor(inference.Config(prefix))
    eng = serving.InferenceEngine(pred, max_batch_size=8,
                                  batch_timeout_ms=5.0)
    try:
        eng.warmup()
        assert eng._out_mask == [True, False]
        futs = [eng.infer([np.ones((n, 4), np.float32)])
                for n in (3, 5)]                    # coalesce to 8 rows
        for n, f in zip((3, 5), futs):
            out = f.result(timeout=30)
            assert out[0].shape == (n, 2)
            assert out[1].shape == (8, 3)           # whole fixed output
            np.testing.assert_array_equal(out[1], np.ones((8, 3)))
    finally:
        eng.close()


# ------------------------------------------------- weights hot swap --
def test_prewarm_rejects_input_name_mismatch(artifact):
    class WrongSignature:
        def get_input_names(self):
            return ["a", "b"]

    eng, _ = _engine(artifact)
    try:
        with pytest.raises(ValueError, match="replacement artifact"):
            eng.prewarm_predictor(WrongSignature())
    finally:
        eng.close()


def test_prewarm_and_swap_predictor(artifact):
    eng, pred = _engine(artifact)
    try:
        new = inference.create_predictor(inference.Config(artifact))
        assert eng.prewarm_predictor(new) == len(eng.buckets)
        old = eng.swap_predictor(new, 5)
        assert old is pred and eng.weights_version == 5
        x = np.ones((2, 8), np.float32)
        np.testing.assert_array_equal(eng.infer_sync([x], timeout=30)[0],
                                      np.asarray(pred.run([x])[0]))
        st = eng.stats()
        assert st["recompiles_after_warmup"] == 0
        assert st["counters"]["weight_swaps"] == 1
    finally:
        eng.close()


def test_swap_on_closed_engine_raises(artifact):
    eng, pred = _engine(artifact)
    eng.close()
    with pytest.raises(serving.EngineClosed):
        eng.swap_predictor(pred, 1)


# --------------------------------------------------------------- http --
def test_http_concurrent_clients(artifact):
    eng, pred = _engine(artifact)
    srv = serving.ServingServer(eng, port=0).start()
    try:
        client = serving.Client(srv.url)
        assert client.healthz()["status"] == "running"
        rng = np.random.RandomState(4)
        reqs = _dyadic_requests(rng, 24)
        refs = [np.asarray(pred.run([x])[0]) for x in reqs]
        results = [None] * len(reqs)

        def worker(idx):
            for i in range(idx, len(reqs), 6):
                results[i] = client.predict(reqs[i])

        threads = [threading.Thread(target=worker, args=(c,))
                   for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for out, ref in zip(results, refs):
            assert out[0].dtype == np.float32
            np.testing.assert_array_equal(out[0], ref)
        m = client.metrics()
        assert m["counters"]["responses"] >= 24
        assert m["recompiles_after_warmup"] == 0
        assert {"p50", "p95", "p99"} <= set(m["latency_ms"])
        assert client.last_trace_id
    finally:
        srv.close()
        eng.close()


def test_http_npy_roundtrip_and_trace_header(artifact):
    import http.client
    eng, pred = _engine(artifact)
    srv = serving.ServingServer(eng, port=0).start()
    try:
        client = serving.Client(srv.url, trace_id="req-42")
        x = (np.arange(24).reshape(3, 8) / 4.0).astype(np.float32)
        out = client.predict_npy(x)
        np.testing.assert_array_equal(out, np.asarray(pred.run([x])[0]))
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=10)
        for sent, echoed in (("req-42", "req-42"), ("bad id!", None)):
            conn.request("GET", "/healthz", headers={"X-Trace-Id": sent})
            r = conn.getresponse()
            r.read()
            got = r.getheader("X-Trace-Id")
            if echoed is None:      # malformed: a fresh id is minted
                assert re.fullmatch(r"[0-9a-f]{32}", got), got
            else:
                assert got == echoed
        # the observability endpoints answer as paddle_tpu's do
        for method, path, key in (("GET", "/perf", "perf"),
                                  ("GET", "/admin/fleet", "fleet"),
                                  ("POST", "/admin/trace", "traceEvents")):
            conn.request(method, path)
            r = conn.getresponse()
            body = json.loads(r.read())
            assert r.status == 200, path
            assert key in body, (path, body)
        conn.close()
    finally:
        srv.close()
        eng.close()


def test_http_error_mapping(artifact):
    eng, _ = _engine(artifact, max_queue=1)
    srv = serving.ServingServer(eng, port=0).start()
    try:
        client = serving.Client(srv.url)
        with pytest.raises(serving.ServingError, match="400"):
            client.predict([np.ones((2, 8)), np.ones((2, 8))])  # 2 inputs
        eng.pause()
        f = eng.infer([np.ones((1, 8), np.float32)])
        with pytest.raises(serving.QueueFull):
            client.predict(np.ones((1, 8), np.float32))
        eng.resume()
        f.result(timeout=30)
        eng.drain(timeout=30)
        assert client.healthz()["status"] in ("draining", "closed")
    finally:
        srv.close()
        eng.close()


def test_http_registry_error_mapping(artifact):
    import http.client
    import json

    eng, _ = _engine(artifact)
    reg = serving.ModelRegistry()
    reg.register("solo", engine=eng)
    reg.set_quota("capped", rate=0.001, burst=1)
    srv = serving.ServingServer(None, port=0, registry=reg).start()
    try:
        client = serving.Client(srv.url)
        x = np.ones((1, 8), np.float32)
        client.predict([x], model="solo")
        with pytest.raises(serving.UnknownModel):
            client.predict([x], model="nope")
        client.predict([x], model="solo", tenant="capped")  # burst spent
        with pytest.raises(serving.QuotaExceeded):
            client.predict([x], model="solo", tenant="capped")
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=10)
        body = json.dumps({"inputs": [x.tolist()], "model": "nope"})
        conn.request("POST", "/predict", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 404
        assert json.loads(resp.read())["error"] == "UnknownModel"
        body = json.dumps({"inputs": [x.tolist()], "model": "solo",
                           "tenant": "capped"})
        conn.request("POST", "/predict", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 429
        assert resp.getheader("Retry-After") is not None
        assert json.loads(resp.read())["error"] == "QuotaExceeded"
        conn.close()
    finally:
        srv.close()
        reg.close()


def test_healthz_readiness_split(artifact):
    eng, _ = _engine(artifact)
    srv = serving.ServingServer(eng, port=0, ready=False).start()
    try:
        client = serving.Client(srv.url)
        assert client.healthz() == {"status": "warming",
                                    "engine_state": "running",
                                    "ready": False, "weights_version": 0}
        assert client._retry_after > 0
        srv.mark_ready()
        assert client.healthz()["ready"] is True
        srv.mark_unready()
        assert client.healthz()["ready"] is False
        srv.mark_ready()
        assert client.healthz()["ready"] is True
    finally:
        srv.close()
        eng.close()


def test_client_rides_through_replica_restart(artifact):
    eng, pred = _engine(artifact)
    srv = serving.ServingServer(eng, port=0).start()
    port = srv.port
    x = (np.ones((2, 8)) / 4.0).astype(np.float32)
    ref = np.asarray(pred.run([x])[0])
    srv.close()                         # the replica goes down
    client = serving.Client(srv.url)
    client.reconnect_backoff_s = 1.0
    box = {}

    def restart():
        time.sleep(0.1)                 # well inside the backoff window
        box["srv"] = serving.ServingServer(eng, port=port).start()

    t = threading.Thread(target=restart)
    t.start()
    try:
        out = client.predict([x])
        np.testing.assert_array_equal(out[0], ref)
        assert client.reconnects >= 1
        assert monitor.get_stat("client.reconnects") >= 1
    finally:
        t.join()
        box["srv"].close()
        eng.close()


# ------------------------------------------------- self-healing rails --
def test_close_deadline_with_wedged_dispatcher(artifact):
    eng, _ = _engine(artifact)
    with fault.inject("serving.dispatch:action=sleep,secs=5,count=1"):
        f = eng.infer([np.ones((1, 8), np.float32)])
        time.sleep(0.2)             # dispatcher picks it up and wedges
        t0 = time.monotonic()
        eng.close(timeout=1.0)
        elapsed = time.monotonic() - t0
    assert elapsed < 4.0            # hard deadline, not the 5 s wedge
    assert f.done()
    with pytest.raises(serving.EngineClosed):
        f.result(timeout=0)
    assert eng.stats()["counters"]["closed_stranded"] == 1


def _sigterm_raises():
    def handler(signum, frame):
        raise KeyboardInterrupt
    return signal.signal(signal.SIGTERM, handler)


def test_sigterm_during_inference_warmup(artifact):
    pred = inference.create_predictor(inference.Config(artifact))
    eng = serving.InferenceEngine(pred, max_batch_size=8,
                                  batch_timeout_ms=5.0)
    orig_feeds = eng._bucket_feeds

    def feeds_then_sigterm(rest_shapes):
        it = orig_feeds(rest_shapes)
        yield next(it)              # first bucket runs...
        os.kill(os.getpid(), signal.SIGTERM)    # ...then the signal
        yield from it

    eng._bucket_feeds = feeds_then_sigterm
    x = (np.ones((2, 8)) / 4.0).astype(np.float32)
    futs = [eng.infer([x]) for _ in range(4)]   # accepted pre-warmup
    prev = _sigterm_raises()
    try:
        with pytest.raises(KeyboardInterrupt):
            eng.warmup()
    finally:
        signal.signal(signal.SIGTERM, prev)
    eng._bucket_feeds = orig_feeds
    assert eng.drain(timeout=60)
    ref = np.asarray(pred.run([x])[0])
    for f in futs:
        assert f.done()
        np.testing.assert_array_equal(f.result(timeout=0)[0], ref)
    eng.close()
    assert eng.stats()["counters"]["closed_stranded"] == 0


def test_sigterm_during_generation_warmup():
    eng = serving.GenerationEngine(make_dyadic_lm(), num_slots=2,
                                   page_size=4, max_context=64)
    results = []

    def client(i):
        try:
            results.append(eng.generate_sync(
                [1, 2, 3, 4], timeout=120, max_new_tokens=4,
                temperature=0.7, seed=i))
        except serving.ServingError as e:
            results.append(e)       # in-band is acceptable; silence not

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    orig_note = eng._note_variant
    fired = []

    def note_then_sigterm(kind, bucket):
        r = orig_note(kind, bucket)
        if not fired and threading.current_thread() \
                is threading.main_thread():
            fired.append(1)         # only interrupt the warmup caller
            os.kill(os.getpid(), signal.SIGTERM)
        return r

    eng._note_variant = note_then_sigterm
    prev = _sigterm_raises()
    try:
        with pytest.raises(KeyboardInterrupt):
            eng.warmup()
    finally:
        signal.signal(signal.SIGTERM, prev)
    eng._note_variant = orig_note
    for t in threads:
        t.join(120)
    assert eng.drain(timeout=60)
    eng.close()
    st = eng.stats()
    assert len(results) == 2
    for r in results:
        assert isinstance(r, (list, serving.ServingError))
    assert st["page_pool"]["in_use"] == 0
    assert st["counters"]["pages_allocated"] \
        == st["counters"]["pages_freed"]


def test_serve_cli_binds_serves_and_drains_on_sigterm(artifact):
    """``python -m paddle_tpu_torch.serving.serve PREFIX --device cpu``:
    ready after warm-up, answers /predict, drains and exits 0 on
    SIGTERM."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.serve", artifact,
         "--port", "0", "--device", "cpu", "--max-batch-size", "4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        url = None
        for line in proc.stdout:
            m = re.search(r"on (http://\S+)", line)
            if m:
                url = m.group(1)
                break
        assert url, proc.stderr.read()
        client = serving.Client(url)
        assert client.healthz()["ready"] is True
        x = (np.arange(16).reshape(2, 8) / 4.0).astype(np.float32)
        pred = inference.create_predictor(inference.Config(artifact))
        np.testing.assert_array_equal(client.predict(x)[0],
                                      np.asarray(pred.run([x])[0]))
        client.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "served 1/1 requests" in out, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ------------------------------------------------- monitor histograms --
def test_stat_observe_and_quantile():
    for mod in (paddle_tpu.utils.monitor, monitor):
        mod.stat_reset("t.lat")
        for v in [1.0] * 50 + [10.0] * 45 + [100.0] * 5:
            mod.stat_observe("t.lat", v)
    for q in (0.5, 0.9, 0.99):
        assert monitor.quantile("t.lat", q) == \
            paddle_tpu.utils.monitor.quantile("t.lat", q)
    assert 1.0 <= monitor.quantile("t.lat", 0.5) < 10.0 ** 0.125 + 1e-9
    assert 10.0 <= monitor.quantile("t.lat", 0.9) < 10.0 ** 1.125 + 1e-9
    assert 80.0 < monitor.quantile("t.lat", 0.99) <= 100.0
    s = monitor.histogram_summary("t.lat")
    assert s["count"] == 100
    assert s["min"] == 1.0 and s["max"] == 100.0
    assert abs(s["mean"] - (50 + 450 + 500) / 100.0) < 1e-9
    raw = monitor.histogram_raw("t.lat")
    assert raw == paddle_tpu.utils.monitor.histogram_raw("t.lat")
    assert monitor.quantile_from_counts(raw["counts"], raw["count"], 0.9,
                                        raw["min"], raw["max"]) == \
        paddle_tpu.utils.monitor.quantile_from_counts(
            raw["counts"], raw["count"], 0.9, raw["min"], raw["max"])
    monitor.stat_reset("t.lat")
    assert monitor.histogram_summary("t.lat")["count"] == 0
    assert monitor.quantile("t.lat", 0.5) == 0.0
    assert monitor.histogram_raw("t.lat") is None


def test_histograms_do_not_disturb_counters():
    monitor.stat_reset()
    monitor.stat_add("c", 2)
    monitor.stat_set("g", 7)
    monitor.stat_observe("h", 3.0)
    assert monitor.all_stats() == {"c": 2, "g": 7}      # counters only
    assert monitor.get_stat("c") == 2
    assert "h" in monitor.all_histograms()
    monitor.stat_reset()
    assert monitor.all_histograms() == {}


def test_quantile_extremes_are_exact():
    monitor.stat_reset("t.q")
    for v in (0.5, 2.0, 7.0):
        monitor.stat_observe("t.q", v)
    assert monitor.quantile("t.q", 0.0) == 0.5
    assert monitor.quantile("t.q", 1.0) == 7.0
