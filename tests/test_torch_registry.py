"""paddle_tpu_torch's ModelRegistry held to paddle_tpu's on the CPU.

The cases of ``tests/test_registry.py`` on the port: routing, aliases,
the default model, readiness, weighted fair queuing at saturation,
tenant token buckets and unload's drain on stub engines (each also run
on paddle_tpu's registry, with the same outcomes and counters), and
unload/reload plus an alias flip under live traffic on real dyadic
artifacts, every answer bitwise paddle_tpu's.  Also the HTTP admin
plane (``/admin/models``) and ``ReplicaSet``.

Not twinned: ``test_elasticity_deterministic_scale_shed_recover``
(``ElasticityController`` needs ``observability/slo.py``: ROADMAP A4c).
"""
import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.testing.chaos import make_dyadic_model as jax_dyadic_model
from paddle_tpu_torch import inference, jit, serving
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.serving import (EngineClosed, ModelRegistry,
                                      QuotaExceeded, UnknownModel)
from paddle_tpu_torch.testing.chaos import make_dyadic_lm, make_dyadic_model
from paddle_tpu_torch.utils import monitor

SIDES = {"jax": (paddle_tpu.serving, paddle_tpu.utils.monitor),
         "port": (serving, monitor)}


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield
    placement.set_default(prev)


class StubEngine:
    """Duck-typed InferenceEngine: futures the test resolves itself, so
    WFQ occupancy is fully controlled."""

    def __init__(self):
        self.weights_version = 1
        self.pending = []
        self.closed = False

    def infer(self, inputs, deadline_ms=None):
        f = cf.Future()
        self.pending.append(f)
        return f

    def release_all(self):
        for f in self.pending:
            if not f.done():
                f.set_result("ok")
        self.pending = []

    def drain(self, timeout=None):
        self.release_all()
        return True

    def close(self, timeout=10.0):
        self.release_all()
        self.closed = True


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition never settled"
        time.sleep(0.01)


# ------------------------------------------------------------ routing --
@pytest.mark.parametrize("side", sorted(SIDES))
def test_routing_aliases_default_unknown(side):
    srv, _ = SIDES[side]
    reg = srv.ModelRegistry()
    reg.register("alpha", engine=StubEngine())
    reg.register("beta", engine=StubEngine(), aliases=["prod"])
    try:
        assert reg.default_model == "alpha"
        assert reg.resolve(None).name == "alpha"
        assert reg.resolve("beta").name == "beta"
        assert reg.resolve("prod").name == "beta"
        with pytest.raises(srv.UnknownModel):
            reg.resolve("nope")
        reg.alias("prod", "alpha")
        assert reg.resolve("prod").name == "alpha"
        reg.set_default("beta")
        assert reg.resolve(None).name == "beta"
        with pytest.raises(ValueError, match="already in use"):
            reg.register("prod", engine=StubEngine())
        with pytest.raises(ValueError, match="shadows"):
            reg.alias("alpha", "beta")
        reg.unalias("prod")
        with pytest.raises(srv.UnknownModel):
            reg.unalias("prod")
        assert reg.models() == ["alpha", "beta"]
    finally:
        reg.close()


def test_describe_and_stats_match_jax():
    views = {}
    for side, (srv, _) in SIDES.items():
        reg = srv.ModelRegistry(max_inflight=4)
        reg.register("alpha", engine=StubEngine(), weight=2.0,
                     artifact="/a")
        reg.register("beta", engine=StubEngine(), aliases=["prod"],
                     ready=False)
        reg.set_quota("t", rate=5.0, burst=2)
        try:
            reg.infer("alpha", [1], tenant="t")
            d = reg.describe()
            for m in d["models"].values():
                m.pop("created", None)
            views[side] = (d, reg.stats()["inflight"])
        finally:
            reg.close()
    assert views["port"] == views["jax"]
    d, inflight = views["port"]
    assert d["models"]["alpha"] == {
        "state": "ready", "weight": 2.0, "weights_version": 1,
        "inflight": 1, "shedding": False, "engines": ["inference"],
        "artifact": "/a"}
    assert d["models"]["beta"]["state"] == "warming"
    assert d["aliases"] == {"prod": "beta"} and d["default"] == "alpha"
    assert d["quotas"] == {"t": {"rate": 5.0, "burst": 2.0}}
    assert inflight == {"alpha": 1, "beta": 0}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_not_ready_model_is_unroutable_until_marked(side):
    srv, _ = SIDES[side]
    reg = srv.ModelRegistry()
    reg.register("gamma", engine=StubEngine(), ready=False)
    try:
        with pytest.raises(srv.EngineClosed):       # 503, not 404
            reg.resolve("gamma")
        reg.mark_ready("gamma")
        assert reg.resolve("gamma").state == "ready"
    finally:
        reg.close()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_close_refuses_late_register(side):
    srv, _ = SIDES[side]
    reg = srv.ModelRegistry()
    reg.register("alpha", engine=StubEngine())
    reg.close()
    with pytest.raises(srv.EngineClosed):
        reg.register("late", engine=StubEngine())


# ---------------------------------------------------------------- WFQ --
@pytest.mark.parametrize("side", sorted(SIDES))
def test_wfq_clamps_at_saturation_only(side):
    srv, mon = SIDES[side]
    shed0 = mon.get_stat("registry.wfq_shed") or 0
    reg = srv.ModelRegistry(max_inflight=8)
    a, b = StubEngine(), StubEngine()
    reg.register("alpha", engine=a, weight=3.0)
    reg.register("beta", engine=b, weight=1.0)
    try:
        for _ in range(6):
            reg.infer("alpha", [1])
        for _ in range(2):
            reg.infer("beta", [1])
        with pytest.raises(srv.QueueFull):
            reg.infer("alpha", [1])
        with pytest.raises(srv.QueueFull):
            reg.infer("beta", [1])
        assert (mon.get_stat("registry.wfq_shed") or 0) - shed0 == 2
        a.pending[0].set_result("ok")
        _wait(lambda: reg.stats()["inflight"]["alpha"] == 5)
        reg.infer("beta", [1])
        assert reg.stats()["inflight"]["beta"] == 3
        a.release_all()
        b.release_all()
        _wait(lambda: sum(reg.stats()["inflight"].values()) == 0)
    finally:
        reg.close()


# -------------------------------------------------------------- quota --
@pytest.mark.parametrize("side", sorted(SIDES))
def test_tenant_quota_token_bucket(side):
    srv, _ = SIDES[side]
    reg = srv.ModelRegistry()
    a = StubEngine()
    reg.register("alpha", engine=a)
    reg.set_quota("t1", rate=0.1, burst=2)
    try:
        reg.infer("alpha", [1], tenant="t1")
        reg.infer("alpha", [1], tenant="t1")
        with pytest.raises(srv.QuotaExceeded, match="retry in"):
            reg.infer("alpha", [1], tenant="t1")
        reg.infer("alpha", [1], tenant="t2")
        reg.infer("alpha", [1])
        reg.clear_quota("t1")
        reg.infer("alpha", [1], tenant="t1")
        a.release_all()
    finally:
        reg.close()


# ------------------------------------------------------------- unload --
@pytest.mark.parametrize("side", sorted(SIDES))
def test_unload_drains_resolves_futures_cleans_aliases(side):
    srv, _ = SIDES[side]
    reg = srv.ModelRegistry()
    b = StubEngine()
    reg.register("beta", engine=b, aliases=["prod"])
    try:
        f = reg.infer("beta", [1])
        summary = reg.unload("beta")
        assert summary == {"model": "beta", "engine_drained": True}
        assert f.result(1) == "ok"
        assert b.closed
        with pytest.raises(srv.UnknownModel):
            reg.resolve("beta")
        with pytest.raises(srv.UnknownModel):
            reg.resolve("prod")
    finally:
        reg.close()


def test_load_weights_dir_names_a4c():
    reg = ModelRegistry()
    with pytest.raises(NotImplementedError, match="A4c"):
        reg.load("m", "/nonexistent", weights_dir="/snapshots")
    assert reg.models() == []


def test_replica_set_scales_supervisors():
    class Sup:
        def __init__(self, i):
            self.name = f"sup{i}"
            self.ready = True
            self.health_url = f"http://127.0.0.1:{9000 + i}/healthz"
            self._stop = threading.Event()

        def run(self):
            self._stop.wait(30)

        def stop(self):
            self._stop.set()

    rs = serving.ReplicaSet(Sup, name="bert")
    try:
        assert rs.scale_to(3) == 3 and rs.count == 3
        d = rs.describe()
        assert [r["url"] for r in d["replicas"]] == [
            "http://127.0.0.1:9000", "http://127.0.0.1:9001",
            "http://127.0.0.1:9002"]
        assert all(r["alive"] and r["restarts"] == 0
                   for r in d["replicas"])
        assert rs.scale_to(1) == 1
        assert rs.describe()["replicas"][0]["supervisor"] == "sup0"
    finally:
        rs.stop()
    assert rs.count == 0


# ----------------------------------- concurrent mutation under fire --
@pytest.fixture(scope="module")
def dyadic_artifacts(tmp_path_factory):
    """Two dyadic MLPs, each saved by both packages from the same
    weights: {name: (jax prefix, port prefix)}."""
    tmp = tmp_path_factory.mktemp("registry_models")
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    prefixes = {}
    try:
        for name, seed, scale in (("a", 7, 1.0), ("b", 11, 0.5)):
            paddle_tpu.seed(seed)
            ref = jax_dyadic_model(in_dim=8, hidden=16, out_dim=4)
            for p in ref.parameters():
                p.set_value(p.numpy() * scale)
            jpfx = str(tmp / f"jax_{name}")
            paddle_tpu.jit.save(ref, jpfx, input_spec=[
                paddle_tpu.jit.InputSpec([None, 8], "float32")])
            model = make_dyadic_model(in_dim=8, hidden=16, out_dim=4)
            model.set_state_dict({k: np.array(v.numpy())
                                  for k, v in ref.state_dict().items()})
            tpfx = str(tmp / f"port_{name}")
            jit.save(model, tpfx,
                     input_spec=[jit.InputSpec([None, 8], "float32")])
            prefixes[name] = (jpfx, tpfx)
    finally:
        placement.set_default(prev)
    return prefixes


def test_concurrent_mutation_under_traffic(dyadic_artifacts):
    """Unload/reload and an alias flip while traffic is in flight: every
    successful answer bitwise paddle_tpu's Predictor's, the only failures
    clean UnknownModel/EngineClosed in the mutation window, generation
    bitwise a serial run, pages reclaimed, nothing stranded."""
    rng = np.random.RandomState(29)
    reqs = [(rng.randint(-8, 9, (rng.randint(1, 4), 8)) / 4.0)
            .astype(np.float32) for _ in range(8)]
    refs = {}
    for k, (jpfx, _) in dyadic_artifacts.items():
        jp = paddle_tpu.inference.create_predictor(
            paddle_tpu.inference.Config(jpfx))
        refs[k] = [np.asarray(jp.run([x])[0]) for x in reqs]
    preds = {k: inference.create_predictor(inference.Config(t))
             for k, (_, t) in dyadic_artifacts.items()}
    prompts = [rng.randint(0, 32, rng.randint(1, 7)).tolist()
               for _ in range(3)]
    ref_gen = serving.GenerationEngine(make_dyadic_lm(), num_slots=4,
                                       page_size=4, max_context=64)
    ref_gen.warmup()
    gen_refs = [ref_gen.generate_sync(prompts[i], timeout=60,
                                      max_new_tokens=4,
                                      temperature=0.7, seed=i)
                for i in range(len(prompts))]
    ref_gen.close()

    reg = ModelRegistry(max_inflight=64)
    eng_a = serving.InferenceEngine(preds["a"], max_batch_size=8,
                                    batch_timeout_ms=2.0,
                                    max_queue=256, name="mutA")
    eng_a.warmup()
    gen_a = serving.GenerationEngine(make_dyadic_lm(), num_slots=4,
                                     page_size=4, max_context=64,
                                     max_queue=256, name="mutA")
    gen_a.warmup()
    reg.register("mutA", engine=eng_a, generation=gen_a, weight=2.0)
    eng_b = serving.InferenceEngine(preds["b"], max_batch_size=8,
                                    batch_timeout_ms=2.0,
                                    max_queue=256, name="mutB")
    eng_b.warmup()
    reg.register("mutB", engine=eng_b, aliases=["prod"])

    stop = threading.Event()
    a_out, b_out, g_out = [], [], []

    def a_client():
        k = 0
        while not stop.is_set():
            i = k % len(reqs)
            k += 1
            try:
                got = reg.infer_sync("mutA", [reqs[i]], timeout=30)
                a_out.append((i, np.asarray(got[0], np.float32)))
            except Exception as e:  # noqa: BLE001 - gated below
                a_out.append((i, e))

    def b_client():
        k = 0
        while not stop.is_set():
            i = k % len(reqs)
            k += 1
            try:
                got = reg.infer_sync("mutB", [reqs[i]], timeout=30)
                b_out.append((i, np.asarray(got[0], np.float32)))
            except Exception as e:  # noqa: BLE001 - gated below
                b_out.append((i, e))
            time.sleep(0.005)

    def g_client():
        k = 0
        while not stop.is_set():
            i = k % len(prompts)
            k += 1
            try:
                s = reg.generate("mutA", prompts[i], max_new_tokens=4,
                                 temperature=0.7, seed=i)
                g_out.append((i, s.result(timeout=60)))
            except Exception as e:  # noqa: BLE001 - gated below
                g_out.append((i, e))

    threads = [threading.Thread(target=f, daemon=True)
               for f in (a_client, b_client, g_client)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        reg.alias("prod", "mutA")
        assert reg.resolve("prod").name == "mutA"
        summary = reg.unload("mutB", timeout=30)
        assert summary["engine_drained"] is True
        window_end = len(b_out)
        reg.load("mutB", dyadic_artifacts["b"][1], warmup=True,
                 engine_kwargs={"max_batch_size": 8,
                                "batch_timeout_ms": 2.0,
                                "max_queue": 256})
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(30)

    assert len(a_out) >= 5 and len(g_out) >= 1, (len(a_out), len(g_out))
    for i, res in a_out:
        assert not isinstance(res, Exception), \
            f"mutA request {i} failed under mutation: {res!r}"
        np.testing.assert_array_equal(res, refs["a"][i])
    clean = (UnknownModel, EngineClosed)
    failures = [r for _, r in b_out if isinstance(r, Exception)]
    assert all(isinstance(r, clean) for r in failures), failures[:3]
    for i, res in b_out:
        if not isinstance(res, Exception):
            np.testing.assert_array_equal(res, refs["b"][i])
    post_reload = [r for _, r in b_out[window_end:]
                   if not isinstance(r, Exception)]
    assert post_reload, "no successful mutB traffic after the reload"
    for i, res in g_out:
        assert not isinstance(res, Exception), \
            f"generation {i} failed under mutation: {res!r}"
        assert list(res) == list(gen_refs[i])

    summary_a = reg.unload("mutA", timeout=60)
    assert summary_a["pages_reclaimed"] is True, summary_a
    assert eng_a.stats()["counters"].get("closed_stranded", 0) == 0
    gc = gen_a.stats()["counters"]
    assert gc["pages_allocated"] == gc["pages_freed"], gc
    assert eng_a.stats()["recompiles_after_warmup"] == 0
    reg.close(timeout=30.0)


# ------------------------------------------------------- admin plane --
def test_http_admin_plane(dyadic_artifacts, tmp_path):
    """Load, alias, route, quota and unload over ``/admin/models`` and
    ``/predict``; readiness follows ``mark_ready``; a fat-fingered admin
    call is a 400, an unknown model a 404."""
    jpfx, tpfx = dyadic_artifacts["a"]
    reg = ModelRegistry()
    srv = serving.ServingServer(registry=reg, port=0, ready=False).start()
    try:
        client = serving.Client(srv.url)
        assert client.healthz()["status"] == "empty"
        out = client.load_model("m", tpfx, aliases=["prod"],
                                engine_kwargs={"max_batch_size": 4})
        assert out == {"loaded": "m", "state": "ready"}
        assert client.healthz()["status"] == "warming"
        srv.mark_ready()
        assert client.healthz()["ready"] is True
        x = (np.arange(16).reshape(2, 8) / 4.0).astype(np.float32)
        jp = paddle_tpu.inference.create_predictor(
            paddle_tpu.inference.Config(jpfx))
        ref = np.asarray(jp.run([x])[0])
        np.testing.assert_array_equal(client.predict(x, model="prod")[0],
                                      ref)
        np.testing.assert_array_equal(client.predict_npy(x, model="m"),
                                      ref)
        assert client.alias_model("canary", "m") == {"alias": "canary",
                                                     "target": "m"}
        assert client.set_quota("t", 0.001, 1) == {"tenant": "t",
                                                   "rate": 0.001}
        client.predict(x, model="canary", tenant="t")
        with pytest.raises(QuotaExceeded):
            client.predict(x, model="canary", tenant="t")
        d = client.admin_models()
        assert d["models"]["m"]["state"] == "ready"
        assert d["aliases"] == {"prod": "m", "canary": "m"}
        m = client.metrics()
        assert m["registry"]["models"] == 1
        with pytest.raises(serving.ServingError, match="400"):
            client._admin({"action": "bogus"})
        with pytest.raises(serving.ServingError, match="400"):
            client._admin({"action": "load", "name": "x"})  # no artifact
        s = client.unload_model("m")
        assert s == {"model": "m", "engine_drained": True}
        with pytest.raises(UnknownModel):
            client.predict(x, model="m")
        assert client.healthz()["status"] == "empty"
    finally:
        srv.close()
        reg.close()
