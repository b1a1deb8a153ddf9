"""paddle_tpu_torch's weight hot swap held to paddle_tpu's on the CPU.

The twelve cases of ``tests/test_hotswap.py`` (publish round trip,
the watcher's apply / reject / rollback on live engines, readiness and
``weights_version`` on ``/healthz`` and Prometheus, the disabled-path
cost contracts), each run on both packages, every package serving its
own artifact of the same dyadic model: paddle_tpu's
``testing.chaos._scaled_artifact`` saves it, and the port saves the
same weights with its own ``jit.save``.  The generation engines serve
the same dyadic LM (paddle_tpu's weights carried across by
``params_from_paddle_tpu``).  Weights and inputs are dyadic, so the
swapped answers are bitwise equal across the packages and the tokens
are equal.

Beyond the twins: the port refuses a snapshot carrying a paddle_tpu
artifact before any commit, ``ModelRegistry.load(weights_dir=...)`` and
the ``serve`` CLI's ``--weights-dir`` swap what they serve, and
``testing.chaos.swap_main(supervised=False)`` passes at a small size.
The gate's supervised leg waits for ROADMAP A5's ``ServingSupervisor``.
A swap on the card is ``tests/test_torch_hotswap_cuda.py``'s.
"""
import json
import os
import signal
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import inference as jax_inference
from paddle_tpu import serving as jax_serving
from paddle_tpu.serving import hotswap as jax_hotswap
from paddle_tpu.testing import chaos as jax_chaos
from paddle_tpu.utils import checkpoint as jax_ckpt
from paddle_tpu.utils import monitor as jax_monitor
from paddle_tpu_torch import inference, jit, serving
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.serving import hotswap
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.utils import checkpoint
from paddle_tpu_torch.utils import monitor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu():
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    yield
    placement.set_default(prev)


def _jax_lm_params():
    return {k: np.asarray(v) for k, v in
            jax_chaos.make_dyadic_lm().params.items()}


def _port_lm():
    lm = chaos.make_dyadic_lm()
    lm.load_state_dict(serving.params_from_paddle_tpu(_jax_lm_params(),
                                                      "cpu"))
    return lm


PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", inference=jax_inference, serving=jax_serving,
        hotswap=jax_hotswap, store=jax_ckpt.SnapshotStore,
        monitor=jax_monitor, lm=jax_chaos.make_dyadic_lm),
    "port": types.SimpleNamespace(
        name="port", inference=inference, serving=serving,
        hotswap=hotswap, store=checkpoint.SnapshotStore, monitor=monitor,
        lm=_port_lm),
}
SIDES = sorted(PKGS)


def _port_artifact(jax_prefix, scale, d, tag, in_dim=8, hidden=16,
                   out_dim=4, seed=5):
    """The port's own ``jit.save`` of paddle_tpu's dyadic model (seed
    ``seed``, weights scaled by ``scale``)."""
    paddle_tpu.seed(seed)
    ref = jax_chaos.make_dyadic_model(in_dim, hidden, out_dim)
    model = chaos.make_dyadic_model(in_dim, hidden, out_dim)
    model.set_state_dict({k: np.array(v.numpy()) * scale
                          for k, v in ref.state_dict().items()})
    prefix = os.path.join(d, f"port_{tag}")
    jit.save(model, prefix,
             input_spec=[jit.InputSpec([None, in_dim], "float32")])
    return prefix


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Per package, two artifacts of the dyadic model: v2's weights are
    v1's scaled by 0.5 (outputs stay exact), so every response is
    attributable to one version."""
    d = str(tmp_path_factory.mktemp("hotswap_artifacts"))
    prev = placement.default()
    paddle_tpu_torch.set_device("cpu")
    try:
        jax = {1: jax_chaos._scaled_artifact(1.0, d, "v1"),
               2: jax_chaos._scaled_artifact(0.5, d, "v2")}
        port = {v: _port_artifact(jax[v], s, d, f"v{v}")
                for v, s in ((1, 1.0), (2, 0.5))}
    finally:
        placement.set_default(prev)
    return {"jax": jax, "port": port}


def _engine(side, prefix, **kw):
    pred = side.inference.create_predictor(side.inference.Config(prefix))
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("batch_timeout_ms", 5.0)
    eng = side.serving.InferenceEngine(pred, **kw)
    eng.warmup()
    return eng, pred


def _gen_params(scale=1.0):
    return {k: (a * scale).astype(a.dtype)
            for k, a in _jax_lm_params().items()}


def _dyadic(rng, n=4, rows=2):
    return [(rng.randint(-8, 9, (rows, 8)) / 4.0).astype(np.float32)
            for _ in range(n)]


def _flip_byte(path, offset=20):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


# ----------------------------------------------------- publish side --
@pytest.mark.parametrize("name", SIDES)
def test_publish_roundtrip(tmp_path, artifacts, name):
    side = PKGS[name]
    store = side.store(str(tmp_path))
    params = _gen_params(0.5)
    meta = side.hotswap.publish_weights(
        store, 7, artifact_prefix=artifacts[name][1], params=params)
    assert int(meta["step"]) == 7
    digs = meta["digests"]
    assert f"{side.hotswap.ARTIFACT_PAYLOAD}.pdparams" in digs
    assert f"{side.hotswap.PARAMS_PAYLOAD}.pdparams" in digs
    loaded = store.load_payloads([side.hotswap.ARTIFACT_PAYLOAD,
                                  side.hotswap.PARAMS_PAYLOAD], meta)
    got = loaded[side.hotswap.PARAMS_PAYLOAD]
    assert set(got) == set(params)
    for k in params:
        np.testing.assert_array_equal(np.asarray(got[k]), params[k])
    with open(artifacts[name][1] + ".pdmodel", "rb") as f:
        raw = f.read()
    assert np.asarray(loaded[side.hotswap.ARTIFACT_PAYLOAD]["pdmodel"],
                      np.uint8).tobytes() == raw


@pytest.mark.parametrize("name", SIDES)
def test_publish_needs_a_payload(tmp_path, name):
    side = PKGS[name]
    with pytest.raises(ValueError, match="artifact_prefix"):
        side.hotswap.publish_weights(side.store(str(tmp_path)), 1)


# ------------------------------------------------------- apply path --
def _apply_both(side, tmp_path, artifacts):
    side.monitor.stat_reset()
    eng, _ = _engine(side, artifacts[side.name][1])
    pred2 = side.inference.create_predictor(
        side.inference.Config(artifacts[side.name][2]))
    gen = side.serving.GenerationEngine(side.lm(), num_slots=2, page_size=4,
                                        max_context=16, prompt_buckets=[4])
    gen.warmup()
    try:
        xs = _dyadic(np.random.RandomState(0))
        refs2 = [np.asarray(pred2.run([x])[0]) for x in xs]
        store = side.store(str(tmp_path / side.name))
        w = side.hotswap.WeightWatcher(store, engine=eng, generation=gen)
        assert w.check_once() is None           # empty store: nothing
        side.hotswap.publish_weights(store, 2,
                                     artifact_prefix=artifacts[side.name][2],
                                     params=_gen_params(0.5))
        assert w.check_once() == 2
        assert eng.weights_version == 2 and gen.weights_version == 2
        outs = [np.asarray(eng.infer_sync([x], timeout=30)[0]) for x in xs]
        for o, r in zip(outs, refs2):
            np.testing.assert_array_equal(o, r)
        toks = gen.generate_sync([1, 2, 3], timeout=60, max_new_tokens=6,
                                 temperature=0.7, seed=5)
        st, gs = eng.stats(), gen.stats()
        assert st["recompiles_after_warmup"] == 0
        assert st["counters"]["weight_swaps"] == 1
        assert st["weights_version"] == 2
        assert gs["recompiles_after_warmup"] == 0
        assert gs["counters"]["weight_swaps"] == 1
        assert side.monitor.get_stat("serving.swap.applied") == 1
        assert w.check_once() is None           # already applied: no-op
        assert side.monitor.get_stat("serving.swap.applied") == 1
        return outs, toks
    finally:
        eng.close()
        gen.close()


def test_watcher_applies_both_engines(tmp_path, artifacts):
    got = {n: _apply_both(PKGS[n], tmp_path, artifacts) for n in SIDES}
    for a, b in zip(got["jax"][0], got["port"][0]):
        np.testing.assert_array_equal(a, b)     # the swapped answers
    assert got["port"][1] == got["jax"][1]      # the swapped weights' tokens
    # a model born with the swapped weights answers the same
    born = _port_lm()
    born.load_state_dict(serving.params_from_paddle_tpu(_gen_params(0.5),
                                                        "cpu"))
    ref = serving.GenerationEngine(born, num_slots=2, page_size=4,
                                   max_context=16, prompt_buckets=[4])
    try:
        assert ref.generate_sync([1, 2, 3], timeout=60, max_new_tokens=6,
                                 temperature=0.7, seed=5) == got["port"][1]
    finally:
        ref.close()


@pytest.mark.parametrize("name", SIDES)
def test_background_watcher_applies(tmp_path, artifacts, name):
    side = PKGS[name]
    eng, _ = _engine(side, artifacts[name][1])
    w = None
    try:
        store = side.store(str(tmp_path))
        w = side.hotswap.WeightWatcher(store, engine=eng, poll_s=0.02).start()
        side.hotswap.publish_weights(store, 2,
                                     artifact_prefix=artifacts[name][2])
        deadline = time.monotonic() + 60
        while w.version != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.version == 2 and eng.weights_version == 2
    finally:
        if w is not None:
            w.stop()
        eng.close()


# --------------------------------------------------- rejection path --
@pytest.mark.parametrize("name", SIDES)
def test_corrupt_snapshot_rejected_and_pinned(tmp_path, artifacts, name):
    side = PKGS[name]
    side.monitor.stat_reset()
    eng, pred1 = _engine(side, artifacts[name][1])
    try:
        store = side.store(str(tmp_path))
        w = side.hotswap.WeightWatcher(store, engine=eng)
        snap = side.hotswap.publish_weights(
            store, 2, artifact_prefix=artifacts[name][2])
        _flip_byte(os.path.join(store.dir, snap["dir"],
                                f"{side.hotswap.ARTIFACT_PAYLOAD}.pdparams"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert w.check_once() is None
        assert w.last_rejected == 2 and eng.weights_version == 0
        assert side.monitor.get_stat("serving.swap.rejected") == 1
        assert w.check_once() is None           # pinned: not retried
        assert side.monitor.get_stat("serving.swap.rejected") == 1
        x = (np.ones((2, 8)) / 4.0).astype(np.float32)
        np.testing.assert_array_equal(
            eng.infer_sync([x], timeout=30)[0],
            np.asarray(pred1.run([x])[0]))      # still serving v0
    finally:
        eng.close()


@pytest.mark.parametrize("name", SIDES)
def test_partial_and_foreign_snapshots(tmp_path, artifacts, name):
    side = PKGS[name]
    side.monitor.stat_reset()
    eng, _ = _engine(side, artifacts[name][1])
    gen = side.serving.GenerationEngine(side.lm(), num_slots=2, page_size=4,
                                        max_context=64)
    try:
        store = side.store(str(tmp_path))
        # params only, inference-only replica: skipped quietly
        w_inf = side.hotswap.WeightWatcher(store, engine=eng)
        side.hotswap.publish_weights(store, 2, params=_gen_params(0.5))
        assert w_inf.check_once() is None
        assert w_inf.last_rejected is None
        assert side.monitor.get_stat("serving.swap.rejected") == 0
        # same snapshot, replica serving both engines: partial -> reject
        w_both = side.hotswap.WeightWatcher(store, engine=eng, generation=gen)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert w_both.check_once() is None
        assert w_both.last_rejected == 2
        assert "partial snapshot" in w_both.last_error
        assert eng.weights_version == 0 and gen.weights_version == 0
    finally:
        eng.close()
        gen.close()


@pytest.mark.parametrize("name", SIDES)
def test_mismatched_artifact_rejected_before_commit(tmp_path, artifacts,
                                                   name):
    """A replacement whose shapes disagree with the serving signature
    fails in prewarm — off the dispatch path, before any commit."""
    side = PKGS[name]
    d = str(tmp_path)
    if name == "jax":
        paddle_tpu.seed(9)
        m = jax_chaos.make_dyadic_model(in_dim=4, hidden=8, out_dim=2)
        prefix = os.path.join(d, "narrow")
        paddle_tpu.jit.save(m, prefix, input_spec=[
            paddle_tpu.jit.InputSpec([None, 4], "float32")])
    else:
        prefix = _port_artifact(None, 1.0, d, "narrow", in_dim=4, hidden=8,
                                out_dim=2, seed=9)
    eng, pred1 = _engine(side, artifacts[name][1])
    try:
        store = side.store(os.path.join(d, "s"))
        w = side.hotswap.WeightWatcher(store, engine=eng)
        side.hotswap.publish_weights(store, 2, artifact_prefix=prefix)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert w.check_once() is None
        assert w.last_rejected == 2
        assert "artifact rejected" in w.last_error
        assert eng.weights_version == 0
        x = (np.ones((1, 8)) / 4.0).astype(np.float32)
        np.testing.assert_array_equal(eng.infer_sync([x], timeout=30)[0],
                                      np.asarray(pred1.run([x])[0]))
    finally:
        eng.close()


def test_paddle_tpu_artifact_in_a_snapshot_is_rejected(tmp_path,
                                                      artifacts):
    """A snapshot carrying paddle_tpu's JAX-format artifact is refused
    before any commit, with ``jit.load``'s message naming both
    formats."""
    monitor.stat_reset()
    eng, pred1 = _engine(PKGS["port"], artifacts["port"][1])
    try:
        store = checkpoint.SnapshotStore(str(tmp_path))
        w = hotswap.WeightWatcher(store, engine=eng)
        hotswap.publish_weights(store, 2,
                                artifact_prefix=artifacts["jax"][2])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert w.check_once() is None
        assert w.last_rejected == 2 and eng.weights_version == 0
        assert "artifact rejected" in w.last_error
        assert "paddle_tpu.stablehlo.v1" in w.last_error
        assert "paddle_tpu_torch.export.v1" in w.last_error
        assert monitor.get_stat("serving.swap.rejected") == 1
    finally:
        eng.close()


@pytest.mark.parametrize("name", SIDES)
def test_prewarm_rejects_input_name_mismatch(artifacts, name):
    class WrongSignature:
        def get_input_names(self):
            return ["a", "b"]

    eng, _ = _engine(PKGS[name], artifacts[name][1])
    try:
        with pytest.raises(ValueError, match="replacement artifact"):
            eng.prewarm_predictor(WrongSignature())
    finally:
        eng.close()


@pytest.mark.parametrize("name", SIDES)
def test_swap_on_closed_engine_raises(artifacts, name):
    side = PKGS[name]
    eng, pred = _engine(side, artifacts[name][1])
    eng.close()
    with pytest.raises(side.serving.EngineClosed):
        eng.swap_predictor(pred, 1)


# ----------------------------------------------------- rollback path --
@pytest.mark.parametrize("name", SIDES)
def test_rollback_when_generation_apply_fails(tmp_path, artifacts, name):
    """The artifact verifies and commits to inference, then the
    generation params are rejected (shape): the inference commit is
    rolled back, still warm."""
    side = PKGS[name]
    side.monitor.stat_reset()
    eng, pred1 = _engine(side, artifacts[name][1])
    gen = side.serving.GenerationEngine(side.lm(), num_slots=2, page_size=4,
                                        max_context=64)
    try:
        store = side.store(str(tmp_path))
        w = side.hotswap.WeightWatcher(store, engine=eng, generation=gen)
        bad = _gen_params(0.5)
        k0 = sorted(bad)[0]
        bad[k0] = bad[k0].reshape(-1)
        side.hotswap.publish_weights(store, 2,
                                     artifact_prefix=artifacts[name][2],
                                     params=bad)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert w.check_once() is None
        assert w.last_rejected == 2
        assert "generation apply failed" in w.last_error
        assert eng.weights_version == 0 and gen.weights_version == 0
        assert side.monitor.get_stat("serving.swap.rolled_back") == 1
        assert side.monitor.get_stat("serving.swap.applied") == 0
        st = eng.stats()
        assert st["counters"]["weight_swaps"] == 2  # commit + rollback
        assert st["recompiles_after_warmup"] == 0
        x = (np.ones((2, 8)) / 4.0).astype(np.float32)
        np.testing.assert_array_equal(eng.infer_sync([x], timeout=30)[0],
                                      np.asarray(pred1.run([x])[0]))
    finally:
        eng.close()
        gen.close()


# ------------------------------------------------------ observability --
@pytest.mark.parametrize("name", SIDES)
def test_healthz_and_prometheus_surfaces(tmp_path, artifacts, name):
    side = PKGS[name]
    eng, _ = _engine(side, artifacts[name][1])
    srv = side.serving.ServingServer(eng, port=0, ready=False).start()
    try:
        client = side.serving.Client(srv.url)
        h = client.healthz()
        assert h["status"] == "warming" and h["ready"] is False
        assert client._retry_after > 0
        srv.mark_ready()
        h = client.healthz()
        assert h["ready"] is True and h["weights_version"] == 0
        store = side.store(str(tmp_path))
        w = side.hotswap.WeightWatcher(store, engine=eng)
        side.hotswap.publish_weights(store, 5,
                                     artifact_prefix=artifacts[name][2])
        assert w.check_once() == 5
        assert client.healthz()["weights_version"] == 5
        text = client.metrics_text()
        assert "paddle_tpu_serving_weights_version 5" in text
        assert "paddle_tpu_serving_ready 1" in text
        srv.mark_unready()
        assert client.healthz()["status"] == "warming"
        assert "paddle_tpu_serving_ready 0" in client.metrics_text()
        client.close()
    finally:
        srv.close()
        eng.close()


# ------------------------------------------------- cost contracts ----
@pytest.mark.parametrize("name", SIDES)
def test_disabled_path_cost_contracts(name):
    """Swap support costs the steady state one attribute check in the
    scheduler loop and nothing on the per-batch / per-step paths;
    liveness is one heartbeat hook a dispatch and a decode step."""
    InferenceEngine = PKGS[name].serving.InferenceEngine
    GenerationEngine = PKGS[name].serving.GenerationEngine
    # the port's scheduler loop is ``_serve`` under a ``_loop`` that
    # makes the engine's device current
    loop = (GenerationEngine._serve if name == "port"
            else GenerationEngine._loop).__code__.co_names
    assert "_pending_swap" in loop and "_commit_swap_locked" in loop
    for fn in (GenerationEngine._decode_step, GenerationEngine._prefill):
        names = fn.__code__.co_names
        assert "_pending_swap" not in names
        assert "_commit_swap_locked" not in names
        assert "swap_weights" not in names
    exe = InferenceEngine._execute.__code__.co_names
    assert "_pending_swap" not in exe and "swap_predictor" not in exe
    assert "_heartbeat" in exe
    assert "_heartbeat" in GenerationEngine._decode_step.__code__.co_names


# ------------------------------------------- the port's serving paths --
def test_registry_load_weights_dir_swaps_the_model(tmp_path, artifacts):
    """``ModelRegistry.load(weights_dir=...)`` runs a watcher on the
    store: a published version reaches the routed engine; unload stops
    the watcher before it drains."""
    monitor.stat_reset()
    reg = serving.ModelRegistry()
    store = checkpoint.SnapshotStore(str(tmp_path / "weights"))
    try:
        entry = reg.load("m", artifacts["port"][1], weights_dir=store.dir,
                         weights_poll_s=0.02, engine_kwargs={
                             "max_batch_size": 8, "batch_timeout_ms": 2.0})
        assert entry.watcher is not None
        x = (np.ones((2, 8)) / 4.0).astype(np.float32)
        before = reg.infer_sync("m", [x], timeout=30)[0]
        hotswap.publish_weights(store, 3,
                                artifact_prefix=artifacts["port"][2])
        deadline = time.monotonic() + 60
        while entry.weights_version != 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert entry.weights_version == 3
        after = reg.infer_sync("m", [x], timeout=30)[0]
        want = inference.create_predictor(inference.Config(
            artifacts["port"][2])).run([x])[0]
        np.testing.assert_array_equal(after, np.asarray(want))
        assert not np.array_equal(after, before)
        assert reg.describe()["models"]["m"]["weights_version"] == 3
        reg.unload("m")
        assert not entry.watcher._thread.is_alive()
    finally:
        reg.close()


def test_serve_cli_weights_dir_swaps_the_served_model(tmp_path, artifacts):
    store = checkpoint.SnapshotStore(str(tmp_path / "weights"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.serve",
         artifacts["port"][1], "--device", "cpu", "--port", "0",
         "--weights-dir", store.dir, "--weights-poll-s", "0.05",
         "--max-batch-size", "4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        url = None
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                url = line.split(" on ")[1].split()[0]
                break
        assert url, "".join(lines)
        assert any("watching" in ln for ln in lines), lines
        client = serving.Client(url)
        x = (np.ones((1, 8)) / 4.0).astype(np.float32)
        before = client.predict(x)[0]
        hotswap.publish_weights(store, 4,
                                artifact_prefix=artifacts["port"][2])
        deadline = time.monotonic() + 60
        while (client.healthz()["weights_version"] != 4
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert client.healthz()["weights_version"] == 4
        want = inference.create_predictor(inference.Config(
            artifacts["port"][2])).run([x])[0]
        after = client.predict(x)[0]
        np.testing.assert_array_equal(after, np.asarray(want))
        assert not np.array_equal(after, before)
        client.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert "draining" in out


def test_swap_main_in_process_small():
    """``chaos.swap_main(supervised=False)``: three live swaps under
    concurrent traffic, one corrupted snapshot rejected."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert chaos.swap_main(requests=8, clients=2,
                               supervised=False) == 0
    with pytest.raises(NotImplementedError, match="A5"):
        chaos.swap_main(supervised=True)
