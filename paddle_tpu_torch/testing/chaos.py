"""Chaos drills (the counterpart of ``paddle_tpu/testing/chaos.py``):
the dyadic models, the swap-under-fire gate (:func:`swap_main`, with
its supervised replica crash), the supervised training drill
(:func:`supervise_main`: an injected NaN step, hang and crash, with the
supervisor's test fixtures ``_sv_*_entry``) and the data-plane anomaly
drill (:func:`anomaly_main`, on gloo ranks).  The other gates (the
training preemption, resharding, registry and fleet drills) are ROADMAP
A7's.

Weights that are small dyadic rationals, fed inputs that are dyadic
too, make every product and partial sum exactly representable in
float32: outputs are bitwise the same whatever the batch coalescing,
padding or reduction order.  The serving engines' tests and the swap
gate hold that."""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

__all__ = ["make_dyadic_model", "make_dyadic_lm", "swap_main",
           "supervise_main", "anomaly_main", "AnomalyDataset",
           "ANOMALY_CHAOS_SPEC"]


def make_dyadic_model(in_dim=8, hidden=16, out_dim=4):
    """A tiny MLP whose weights are rounded to k/8, on the default
    device (``set_device``)."""
    from .. import nn

    model = nn.Sequential(nn.Linear(in_dim, hidden), nn.ReLU(),
                          nn.Linear(hidden, out_dim))
    for p in model.parameters():
        p.set_value(np.round(p.numpy() * 8.0) / 8.0)
    return model


def make_dyadic_lm(**kw):
    """A tiny ``PagedDecoderLM`` with k/64 dyadic weights: per-row
    decode math reproduces bitwise in any slot, batch or page
    placement."""
    from ..serving import PagedDecoderLM

    kw.setdefault("vocab_size", 32)
    kw.setdefault("hidden", 16)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("seed", 3)
    return PagedDecoderLM(dyadic=True, **kw)


# ---------------------------------------------------------------------------
# Hot-swap chaos: digest-verified weight swaps under concurrent traffic
# and one corrupted snapshot
# ---------------------------------------------------------------------------

def _scaled_artifact(scale, workdir, tag):
    """``jit.save`` the dyadic inference model with every weight scaled
    by ``scale``.  Power-of-two scales keep every value exactly
    representable, so each published version has its own bitwise-exact
    reference outputs — which is what lets the swap gate attribute
    every served response to exactly one weights version."""
    from .. import jit, seed
    from ..jit import InputSpec

    seed(5)
    model = make_dyadic_model()
    for p in model.parameters():
        p.set_value(p.numpy() * scale)
    prefix = os.path.join(workdir, f"m_{tag}")
    jit.save(model, prefix, input_spec=[InputSpec([None, 8], "float32")])
    return prefix


def swap_main(requests=16, clients=3, verbose=False, workdir=None,
              supervised=True):
    """Swap-under-fire gate; returns 0 on success, 1 on failure.

    Part one (in-process, engines under concurrent traffic): a
    :class:`~..serving.hotswap.WeightWatcher` applies three
    live weight swaps (versions 1..3) to an InferenceEngine AND a
    GenerationEngine while client threads hammer both, then one
    deliberately corrupted snapshot (version 4) must be rejected with
    the engines still serving version 3.  Gates: every response is
    bitwise-correct for *some* published version (inference batches
    run under exactly one predictor, so no response may mix versions;
    generation sequences that demonstrably ran inside one version must
    match that version's serial reference), each applied version is
    bitwise-verified by a settled serial pass, ``/healthz`` readiness
    stays green through every applied swap, zero hot-path recompiles,
    zero stranded futures, and the page pool is fully reclaimed.

    Part two (``supervised=True``): a ``ServingSupervisor`` replica
    (a child process serving the version-0 artifact over HTTP) crashes
    hard mid-traffic; the supervisor restarts it, the replacement
    re-warms and goes ready, clients ride through on the reconnect path
    (``client.reconnects``), and every answer equals version 0's.

    The engines and the models live on the default device
    (``set_device``, else the current CUDA device); the replica runs on
    the same device.
    """
    from .. import inference, serving
    from ..serving.hotswap import (PARAMS_PAYLOAD, WeightWatcher,
                                   publish_weights)
    from ..utils import monitor
    from ..utils.checkpoint import SnapshotStore

    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="chaos_swap_")
    problems = []
    monitor.stat_reset()
    scales = {0: 1.0, 1: 0.5, 2: 0.25, 3: 2.0}

    # -- per-version bitwise references -----------------------------------
    prefixes = {v: _scaled_artifact(s, workdir, f"v{v}")
                for v, s in scales.items()}
    preds = {v: inference.create_predictor(inference.Config(prefixes[v]))
             for v in scales}
    rng = np.random.RandomState(17)
    reqs = [(rng.randint(-8, 9, (rng.randint(1, 5), 8)) / 4.0)
            .astype(np.float32) for _ in range(requests)]
    inf_refs = {v: [np.asarray(preds[v].run([x])[0]) for x in reqs]
                for v in scales}
    for v in (1, 2, 3):
        if all(np.array_equal(a, b)
               for a, b in zip(inf_refs[v], inf_refs[0])):
            problems.append(f"version {v} artifact is output-identical "
                            f"to version 0 (swap would be unobservable)")

    base_params = {k: v.detach().cpu().numpy().copy()
                   for k, v in make_dyadic_lm().params.items()}
    params_for = {v: {k: a * s for k, a in base_params.items()}
                  for v, s in scales.items()}
    prompts = [rng.randint(0, 32, rng.randint(1, 9)).tolist()
               for _ in range(6)]
    budgets = [int(rng.randint(3, 7)) for _ in prompts]

    # generation references: ONE warmed engine, serially hot-swapped
    # through the version sequence (idle swaps — also a deterministic
    # exercise of the staged-commit path itself)
    ref_gen = serving.GenerationEngine(make_dyadic_lm(), num_slots=4,
                                       page_size=4, max_context=64,
                                       max_queue=64)
    ref_gen.warmup()
    gen_refs = {}
    for v in sorted(scales):
        if v:
            ref_gen.swap_weights(params_for[v], v)
        gen_refs[v] = [ref_gen.generate_sync(
            prompts[i], timeout=60, max_new_tokens=budgets[i],
            temperature=0.7, seed=i) for i in range(len(prompts))]
    ref_stats = ref_gen.stats()
    ref_gen.close()
    if ref_stats["counters"]["weight_swaps"] != 3 \
            or ref_stats["recompiles_after_warmup"] != 0:
        problems.append(
            f"reference engine: {ref_stats['counters']['weight_swaps']} "
            f"swaps, {ref_stats['recompiles_after_warmup']} recompiles "
            f"(expected 3 swaps, 0 recompiles)")

    # -- part one: live engines, watcher, fire ------------------------------
    engine = serving.InferenceEngine(preds[0], max_batch_size=8,
                                     batch_timeout_ms=5.0,
                                     max_queue=8 * requests)
    engine.warmup()
    gen = serving.GenerationEngine(make_dyadic_lm(), num_slots=4,
                                   page_size=4, max_context=64,
                                   max_queue=256)
    gen.warmup()
    srv = serving.ServingServer(engine, generation=gen, port=0).start()
    store = SnapshotStore(os.path.join(workdir, "weights"))
    watcher = WeightWatcher(store, engine=engine, generation=gen,
                            poll_s=0.05).start()

    stop = threading.Event()
    ready_bad, versions_seen, probes = [], set(), [0]
    inf_outcomes, gen_outcomes = [], []

    def prober():
        c = serving.Client(srv.url)
        while not stop.is_set():
            h = c.healthz()
            probes[0] += 1
            if not h.get("ready") or h.get("status") != "running":
                ready_bad.append(dict(h))
            versions_seen.add(int(h.get("weights_version", -1)))
            time.sleep(0.01)

    def inf_client(idx):
        k = idx
        while not stop.is_set():
            i = k % len(reqs)
            k += clients
            try:
                out = engine.infer_sync([reqs[i]], timeout=30)
                inf_outcomes.append((i, np.asarray(out[0])))
            except Exception as e:  # noqa: BLE001 - gated below
                inf_outcomes.append((i, e))

    def gen_client(idx):
        k = idx
        while not stop.is_set():
            i = k % len(prompts)
            k += clients
            v_before = gen.weights_version
            try:
                toks = gen.generate_sync(
                    prompts[i], timeout=60, max_new_tokens=budgets[i],
                    temperature=0.7, seed=i)
                gen_outcomes.append((i, v_before, gen.weights_version,
                                     toks))
            except Exception as e:  # noqa: BLE001 - gated below
                gen_outcomes.append((i, v_before, -1, e))

    threads = [threading.Thread(target=prober, daemon=True)]
    threads += [threading.Thread(target=inf_client, args=(c,),
                                 daemon=True) for c in range(clients)]
    threads += [threading.Thread(target=gen_client, args=(c,),
                                 daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.4)                 # traffic lands on version 0
        for v in (1, 2, 3):
            publish_weights(store, v, artifact_prefix=prefixes[v],
                            params=params_for[v])
            deadline = time.monotonic() + 60
            while watcher.version < v \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            if watcher.version != v:
                problems.append(
                    f"swap to version {v} not applied within 60s "
                    f"(last_error={watcher.last_error})")
                break
            # settled serial pass: the freshly applied version must
            # answer bitwise-correctly under its OWN references while
            # the fire traffic keeps coalescing around these requests
            for i in range(3):
                out = engine.infer_sync([reqs[i]], timeout=30)
                if not np.array_equal(out[0], inf_refs[v][i]):
                    problems.append(
                        f"version {v}: settled inference response {i} "
                        f"not bitwise (max |d|="
                        f"{np.abs(out[0] - inf_refs[v][i]).max():.3e})")
            toks = gen.generate_sync(prompts[0], timeout=60,
                                     max_new_tokens=budgets[0],
                                     temperature=0.7, seed=0)
            if toks != gen_refs[v][0]:
                problems.append(f"version {v}: settled generation not "
                                f"bitwise ({toks} != {gen_refs[v][0]})")
            if verbose:
                print(f"swap v{v} applied "
                      f"(engine={engine.weights_version} "
                      f"gen={gen.weights_version})")
            time.sleep(0.4)             # fire window on this version

        # -- the corrupted snapshot: rejected, never applied -------------
        # (stop the poller first so the byte flip is atomic w.r.t. the
        # watcher — a real corruption races the same way: the digest
        # check, not timing, is the defense)
        watcher.stop()
        publish_weights(store, 4, artifact_prefix=prefixes[3],
                        params=params_for[3])
        snap = store.latest_snapshot()
        path = os.path.join(store.dir, snap["dir"],
                            f"{PARAMS_PAYLOAD}.pdparams")
        with open(path, "r+b") as f:
            f.seek(20)
            b = f.read(1)
            f.seek(20)
            f.write(bytes([b[0] ^ 0xFF]))
        import warnings as _warnings
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            got = watcher.check_once()
        if got is not None or watcher.last_rejected != 4:
            problems.append(
                f"corrupted snapshot not rejected (applied={got}, "
                f"last_rejected={watcher.last_rejected})")
        if engine.weights_version != 3 or gen.weights_version != 3:
            problems.append(
                f"engines moved off version 3 after a corrupt publish "
                f"(engine={engine.weights_version}, "
                f"gen={gen.weights_version})")
        out = engine.infer_sync([reqs[0]], timeout=30)
        if not np.array_equal(out[0], inf_refs[3][0]):
            problems.append("post-corruption response no longer bitwise "
                            "at version 3")
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        watcher.stop()
        srv.close()
    engine.drain(timeout=30)
    gen.drain(timeout=60)
    stats = engine.stats()
    gen_stats = gen.stats()
    engine.close()
    gen.close()

    # -- part-one gates ----------------------------------------------------
    version_set = set(scales)
    for i, res in inf_outcomes:
        if isinstance(res, Exception):
            problems.append(f"inference request {i} failed under swap "
                            f"fire: {type(res).__name__}: {res}")
        elif not any(np.array_equal(res, inf_refs[v][i])
                     for v in version_set):
            problems.append(
                f"inference request {i}: response matches NO published "
                f"version (a swap tore a batch)")
    stable = 0
    for i, v0, v1, res in gen_outcomes:
        if isinstance(res, Exception):
            problems.append(f"generation request {i} failed under swap "
                            f"fire: {type(res).__name__}: {res}")
        elif v0 == v1 and v0 in version_set:
            stable += 1
            if res != gen_refs[v0][i]:
                problems.append(
                    f"generation request {i} ran entirely under "
                    f"version {v0} but tokens differ from its serial "
                    f"reference: {res} != {gen_refs[v0][i]}")
    if stable < 1:
        problems.append("no generation request ran inside a single "
                        "weights version (fire windows too short)")
    if probes[0] < 20:
        problems.append(f"readiness poller made only {probes[0]} probes")
    if ready_bad:
        problems.append(f"readiness went red during swaps: "
                        f"{ready_bad[:3]} ({len(ready_bad)} probes)")
    if not versions_seen <= {0, 1, 2, 3}:
        problems.append(f"/healthz exposed unexpected weights versions: "
                        f"{sorted(versions_seen)}")
    if monitor.get_stat("serving.swap.applied") != 3:
        problems.append(f"serving.swap.applied="
                        f"{monitor.get_stat('serving.swap.applied')}, "
                        f"expected 3")
    if monitor.get_stat("serving.swap.rejected") != 1:
        problems.append(f"serving.swap.rejected="
                        f"{monitor.get_stat('serving.swap.rejected')}, "
                        f"expected 1")
    if stats["recompiles_after_warmup"] != 0:
        problems.append(f"inference hot path recompiled "
                        f"{stats['recompiles_after_warmup']}x across "
                        f"swaps")
    if gen_stats["recompiles_after_warmup"] != 0:
        problems.append(f"decode hot path recompiled "
                        f"{gen_stats['recompiles_after_warmup']}x "
                        f"across swaps")
    if stats["counters"].get("closed_stranded", 0):
        problems.append(f"{stats['counters']['closed_stranded']} "
                        f"futures stranded at close")
    if gen_stats["page_pool"]["in_use"] != 0 \
            or gen_stats["counters"]["pages_allocated"] \
            != gen_stats["counters"]["pages_freed"]:
        problems.append(
            f"page pool not reclaimed: in_use="
            f"{gen_stats['page_pool']['in_use']}, "
            f"{gen_stats['counters']['pages_allocated']} allocated vs "
            f"{gen_stats['counters']['pages_freed']} freed")
    if verbose:
        print(f"swap fire: {len(inf_outcomes)} inference + "
              f"{len(gen_outcomes)} generation requests "
              f"({stable} version-stable), "
              f"swaps={stats['counters']['weight_swaps']}/"
              f"{gen_stats['counters']['weight_swaps']}, probes="
              f"{probes[0]}")

    # -- part two: supervised replica crash mid-traffic --------------------
    if supervised and not problems:
        problems.extend(_swap_supervised(prefixes[0], inf_refs[0], reqs,
                                         workdir, verbose))

    if own_tmp:
        shutil.rmtree(workdir, ignore_errors=True)
    if problems:
        for p in problems:
            print(f"FAIL: {p}", file=sys.stderr)
        return 1
    print("chaos swap OK: three live weight swaps applied under "
          "concurrent traffic (bitwise per version, readiness green, "
          "0 recompiles), a corrupted snapshot rejected with the old "
          "weights still serving"
          + (", and a crashed supervised replica restarted with clients "
             "riding through" if supervised else ""))
    return 0


def _swap_serving_entry(prefix, port, state_file, stop_file, device):
    """Supervised serving replica (module level, so spawn can pickle
    it): binds the HTTP plane not ready, warms the batch buckets, marks
    ready, then serves until ``stop_file`` appears.  The first
    incarnation exits hard (``os._exit(9)``) about a second after it
    went ready, with the parent's clients mid-request."""
    from .. import inference, serving, set_device

    if device == "cpu":
        import torch
        torch.set_num_threads(1)    # beside other processes' work
    set_device(device)
    pred = inference.create_predictor(inference.Config(prefix))
    engine = serving.InferenceEngine(pred, max_batch_size=8,
                                     batch_timeout_ms=5.0)
    srv = serving.ServingServer(engine, port=port, ready=False).start()
    engine.warmup()
    srv.mark_ready()
    if not os.path.exists(state_file):
        with open(state_file, "w") as f:
            f.write("1")

        def _die():
            time.sleep(1.0)
            os._exit(9)         # a hard replica crash, mid-traffic

        threading.Thread(target=_die, daemon=True).start()
    while not os.path.exists(stop_file):
        time.sleep(0.05)
    srv.close()
    engine.drain(timeout=10.0)
    engine.close()


def _swap_supervised(prefix, refs, reqs, workdir, verbose):
    """Part two of :func:`swap_main`: the supervised replica crash.
    Returns a list of failure strings."""
    from .. import get_device, serving
    from ..distributed.launch import free_port
    from ..distributed.supervisor import ServingSupervisor
    from ..utils import monitor

    out = []
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    state_file = os.path.join(workdir, "sv_state")
    stop_file = os.path.join(workdir, "sv_stop")
    sv = ServingSupervisor(
        _swap_serving_entry,
        args=(prefix, port, state_file, stop_file, str(get_device())),
        name="swapchaos", health_url=f"{url}/healthz",
        ready_poll_s=0.1, probe_timeout_s=2.0, ready_fail_budget=50,
        hang_deadline_s=300.0, startup_timeout_s=240.0, poll_s=0.1,
        backoff_s=0.1, backoff_max_s=0.5, crash_window_s=600.0,
        crash_budget=3, workdir=workdir)
    box = {}

    def run_sv():
        try:
            box["result"] = sv.run()
        except Exception as e:  # noqa: BLE001 - surfaced below
            box["error"] = e

    svt = threading.Thread(target=run_sv, daemon=True)
    svt.start()

    def wait_ready(deadline_s):
        deadline = time.monotonic() + deadline_s
        c = serving.Client(url, timeout=5, reconnect_backoff_s=0.05)
        while time.monotonic() < deadline:
            try:
                if c.healthz().get("ready"):
                    return True
            except Exception:  # noqa: BLE001 - replica not up yet
                pass
            time.sleep(0.1)
        return False

    successes, failures = [], []
    b_stop = threading.Event()

    def b_client(idx):
        c = serving.Client(url, timeout=10, reconnect_backoff_s=0.1)
        k = idx
        while not b_stop.is_set():
            i = k % len(reqs)
            k += 2
            try:
                got = c.predict([reqs[i]])
                successes.append((i, np.asarray(got[0], dtype=np.float32)))
            except Exception as e:  # noqa: BLE001 - gated below
                failures.append((i, e))
            time.sleep(0.01)

    clients = []
    try:
        if not wait_ready(240.0):
            return ["supervised replica never became ready"]
        clients = [threading.Thread(target=b_client, args=(c,),
                                    daemon=True) for c in range(2)]
        for t in clients:
            t.start()
        # the first incarnation crashes ~1 s after ready; wait for the
        # supervisor to notice and restart it
        deadline = time.monotonic() + 120
        while monitor.get_stat("supervisor.serving.restarts") < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        if monitor.get_stat("supervisor.serving.restarts") < 1:
            return ["replica crash never triggered a supervised restart"]
        if not wait_ready(240.0):
            return ["restarted replica never became ready again"]
        # post-restart: a fresh client, a serial bitwise pass
        c = serving.Client(url, timeout=10)
        for i in range(3):
            arr = np.asarray(c.predict([reqs[i]])[0], dtype=np.float32)
            if not np.array_equal(arr, refs[i]):
                out.append(f"post-restart response {i} not bitwise "
                           f"(max |d|={np.abs(arr - refs[i]).max():.3e})")
        # the supervisor's own probe must see the replacement ready
        # before the stop file ends it (its probes are a poll apart)
        deadline = time.monotonic() + 60
        while monitor.get_stat("supervisor.serving.ready_up") < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        b_stop.set()
        for t in clients:
            t.join(30)
        with open(stop_file, "w") as f:
            f.write("1")
        svt.join(300)
        sv.stop()

    if "error" in box:
        out.append(f"supervisor died: {type(box['error']).__name__}: "
                   f"{box['error']}")
        return out
    result = box.get("result")
    if result is None:
        out.append("supervisor did not finish after the stop file")
        return out
    if not result.clean_exit or result.attempts != 2:
        out.append(f"expected 2 incarnations ending cleanly, got "
                   f"attempts={result.attempts} "
                   f"clean_exit={result.clean_exit}")
    reasons = [r["reason"] for r in result.exit_history]
    if not reasons or "crash(exit=9)" not in reasons[0]:
        out.append(f"first exit reason {reasons[:1]} != crash(exit=9)")
    if monitor.get_stat("supervisor.serving.starts") != 2:
        out.append(f"supervisor.serving.starts="
                   f"{monitor.get_stat('supervisor.serving.starts')}, "
                   f"expected 2")
    if monitor.get_stat("supervisor.serving.ready_up") < 2:
        out.append("readiness never came up twice (no observable "
                   "not-ready -> re-warm -> ready transition)")
    if monitor.get_stat("client.reconnects") < 1:
        out.append("clients never exercised the reconnect path "
                   "(client.reconnects=0)")
    for i, arr in successes:
        if not np.array_equal(arr, refs[i]):
            out.append(f"ride-through response {i} not bitwise")
            break
    if not successes:
        out.append("no client request succeeded across the restart")
    bad = [f for _, f in failures
           if not isinstance(f, (serving.ServingError, OSError))]
    if bad:
        out.append(f"restart-window failures were not clean connection "
                   f"errors: {[type(b).__name__ for b in bad[:3]]}")
    if verbose:
        print(f"supervised: {len(successes)} ok / {len(failures)} "
              f"refused during restart, reconnects="
              f"{monitor.get_stat('client.reconnects')}, exits={reasons}")
    return out


# ---------------------------------------------------------------------------
# Supervised training: an injected NaN step, hang and crash
# ---------------------------------------------------------------------------

D = 16      # the drill MLP's input width


def _sv_flaky_entry(state_file, failures=2, code=5):
    """Supervisor test fixture (module level, so spawn children can
    unpickle it): exit ``code`` for the first ``failures`` incarnations
    (the counter persists in ``state_file``), then exit cleanly."""
    n = 0
    if os.path.exists(state_file):
        with open(state_file) as f:
            n = int(f.read())
    with open(state_file, "w") as f:
        f.write(str(n + 1))
    if n < failures:
        sys.exit(code)


def _sv_slow_start_entry(state_file, quiet_s=2.0):
    """Supervisor test fixture: the first incarnation beats at step
    scale, then crashes; the second stays silent for ``quiet_s`` (a
    restart's build wall) before it beats and finishes.  That quiet
    start must be judged by ``startup_timeout_s``, not by the
    step-scale deadline the retained interval window would give."""
    from ..distributed.supervisor import current_heartbeat

    hb = current_heartbeat()
    if not os.path.exists(state_file):
        with open(state_file, "w") as f:
            f.write("1")
        for i in range(10):
            hb.beat(i)
            time.sleep(0.02)
        sys.exit(3)
    time.sleep(quiet_s)            # 'building': no step beats
    hb.beat(0)


def _sv_hang_entry(state_file, beats=6, interval=0.05):
    """Supervisor test fixture: beat by hand for a while, then wedge
    (sleep 600 s) in the first incarnation; exit cleanly in the second:
    a hang the watchdog must clear exactly once."""
    from ..distributed.supervisor import current_heartbeat

    if os.path.exists(state_file):
        return
    with open(state_file, "w") as f:
        f.write("1")
    hb = current_heartbeat()
    for i in range(beats):
        hb.beat(i)
        time.sleep(interval)
    time.sleep(600)


def _drill_program(model: str, device: str, fleet: bool = False):
    """``(program, loss, feed)`` of the drill's static training program,
    the same in every process: ``"mlp"`` (a 16-8-1 regression MLP under
    Adam, on the CPU in the tests; with ``fleet`` its optimizer goes
    through ``fleet.distributed_optimizer``, data parallel over the job's
    ranks) or ``"bert_static"`` (``bench_pallas``'s static BERT-base at
    ``bench.py:1108``'s widths: batch 16, seq 512, f32, on the card)."""
    import torch

    from .. import seed, static

    if model == "bert_static":
        from .models import build_bert_static
        main, loss, feeds = build_bert_static(
            vocab=30522, hidden=768, layers=12, heads=12, ffn=3072,
            seq=512, batch=16, device=device)
        feed = {k: torch.from_numpy(v).to(device)
                for k, v in feeds(np.random.RandomState(0)).items()}
        return main, loss, feed
    if model != "mlp":
        raise ValueError(f"drill model {model!r}: want 'mlp' or "
                         f"'bert_static'")
    from .. import optimizer
    from ..nn import functional as F

    seed(1234)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, D], "float32")
        y = static.data("y", [None, 1], "float32")
        h = static.nn.fc(x, 8)
        loss = F.mse_loss(static.nn.fc(F.relu(h), 1), y)
        opt = optimizer.Adam(learning_rate=0.05)
        if fleet:
            from .. import distributed as dist
            dist.fleet.init(is_collective=True,
                            strategy=dist.DistributedStrategy())
            opt = dist.fleet.distributed_optimizer(opt)
        opt.minimize(loss)
    rng = np.random.RandomState(7)
    xs = rng.standard_normal((64, D)).astype(np.float32)
    ys = (xs @ rng.standard_normal((D, 1))).astype(np.float32)
    return main, loss, {"x": torch.from_numpy(xs).to(device),
                        "y": torch.from_numpy(ys).to(device)}


def _state_copy(exe, main):
    """Copies of the trained parameters, optimizer slots and update
    counter (the state a flagged run must leave bitwise unchanged)."""
    st = exe._states[main._serial]
    return ([p.detach().clone() for p in main.parameters()],
            {k: {n: t.clone() for n, t in v.items()}
             for k, v in st.slots.items()}, st.step.clone())


def _state_equal(exe, main, before) -> bool:
    import torch
    params, slots, step = before
    st = exe._states[main._serial]
    return (all(torch.equal(a, b.detach())
                for a, b in zip(params, main.parameters()))
            and all(torch.equal(t, st.slots[k][n])
                    for k, v in slots.items() for n, t in v.items())
            and torch.equal(step, st.step))


def _process_start_wall() -> Optional[float]:
    """This process's start on the wall clock, from ``/proc`` (None where
    there is no ``/proc``): the start of a restart's cost."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def _beat_while_saving(step: int, every_s: float = 1.0):
    """Stamp this supervised process's heartbeat every ``every_s`` from
    a thread until the returned event is set: the liveness of a child
    that is saving, not stepping.  Unsupervised, a set event."""
    from ..distributed.supervisor import current_heartbeat
    done = threading.Event()
    hb = current_heartbeat()
    if hb is None:
        done.set()
        return done

    def loop():
        while not done.wait(every_s):
            hb.beat(step)

    threading.Thread(target=loop, daemon=True).start()
    return done


def _supervised_entry(workdir, steps, save_every, model="mlp",
                      device="cpu"):
    """The training entrypoint the supervisor keeps alive.  Every
    incarnation builds the same program, resumes from the newest intact
    snapshot through ``TrainEpochRange`` over the Executor's
    ``sharded_state``, and trains with the anomaly sentry on, an
    ``AnomalyPolicy`` installed and step-cadence snapshots.  Faults
    arrive through ``FLAGS_fault_spec``.  ``<workdir>/steps.jsonl`` is
    the record the parent reads: a resume marker per incarnation, and a
    line per run (its step, loss, sentry flag, whether a flagged run
    left the state bitwise unchanged, and the cumulative kernel
    launches of this incarnation)."""
    import json

    from .. import enable_static, set_device, set_flags, static
    from ..distributed.anomaly import AnomalyPolicy
    from ..ops.cuda import support
    from ..utils.checkpoint import TrainEpochRange
    from . import fault

    t0 = time.perf_counter()
    entry_wall = time.time()
    if device == "cpu":
        import torch
        torch.set_num_threads(1)    # beside other processes' work
    set_device(device)
    set_flags({"anomaly_sentry": True})
    enable_static()
    main, loss, feed = _drill_program(model, device)
    exe = static.Executor(device)
    ss = exe.sharded_state(main)
    built_s = time.perf_counter() - t0
    r = TrainEpochRange(1, f"{workdir}/ckpt", save_every_steps=save_every,
                        train=ss)
    policy = AnomalyPolicy(store=r._store, objects={"train": ss}).install()
    # the runs an armed in-step corruption rule fires at: the state is
    # copied before them, to prove the skipped update a bitwise no-op
    windows = [(rule.after, rule.after + (rule.count or 1))
               for rule in fault.corrupt_rules("executor.grads")]
    support.reset_launch_counts()
    run_i, keepalive = 0, None
    with open(f"{workdir}/steps.jsonl", "a", buffering=1) as log:
        for _epoch in r:
            if keepalive is not None:
                keepalive.set()
            log.write(json.dumps({
                "event": "resume", "step": r.resume_step,
                "pid": os.getpid(), "process_start_wall":
                    _process_start_wall(), "entry_wall": entry_wall,
                "built_s": built_s,
                "start_s": time.perf_counter() - t0}) + "\n")
            step = r.resume_step
            while step < steps:
                run_i = exe._run_counts.get(main._serial, 0) + 1
                watch = (main._serial in exe._states
                         and any(a < run_i <= b for a, b in windows))
                before = _state_copy(exe, main) if watch else None
                policy.note_batch(step)
                val = float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                act = policy.poll()
                rec = {"step": step, "run": run_i, "loss": val,
                       "action": act, "pid": os.getpid(),
                       "launches": dict(support.launch_counts),
                       "t_s": time.perf_counter() - t0}
                if before is not None:
                    rec["noop"] = _state_equal(exe, main, before)
                    rec["sentry"] = exe.sentry_stats(main)
                log.write(json.dumps(rec) + "\n")
                if act == "ok":
                    step += 1
                    r.step()
            # the epoch's end publishes a snapshot and waits for the
            # queued ones: no step beats then, so stamp liveness
            keepalive = _beat_while_saving(run_i)
    if keepalive is not None:
        keepalive.set()
    policy.uninstall()
    exe.close()


def _restart_parts(resumes, runs):
    """Each incarnation's start by part, from its resume marker and its
    first run: process start to the entrypoint (spawn and imports), the
    program's build, the resume (restore of the newest snapshot), and
    the first run."""
    out = []
    for rec in resumes:
        first = next((r for r in runs if r["pid"] == rec["pid"]), None)
        start = rec.get("process_start_wall")
        out.append({
            "spawn_imports_s": (None if start is None
                                else rec["entry_wall"] - start),
            "build_s": rec["built_s"],
            "resume_s": rec["start_s"] - rec["built_s"],
            "first_run_s": (None if first is None
                            else first["t_s"] - rec["start_s"]),
            "resume_step": rec["step"]})
    return out


def supervise_main(steps=10, save_every=2, nan_run=3, hang_run=6,
                   crash_after=2, model="mlp", device="cpu",
                   min_deadline_s=3.0, verbose=False, workdir=None,
                   result=None):
    """Self-healing training gate; returns 0 on success, 1 on failure.

    A ``TrainingSupervisor`` keeps :func:`_supervised_entry` alive
    through:

    1. an injected NaN in the gradients at run ``nan_run`` of the first
       incarnation (``executor.grads:action=corrupt,mode=nan``): the
       sentry flags it, the update is a bitwise no-op, and the policy
       re-delivers the batch;
    2. an injected hang at run ``hang_run`` of the first incarnation
       (``executor.step_hang`` sleep): the watchdog's deadline, from the
       build's ``predicted_step_s``, runs out; SIGTERM, SIGKILL and a
       restart that resumes from the newest step snapshot;
    3. an injected hard crash after ``crash_after`` runs of the second
       (``executor.run`` exit): a restart that resumes again.

    The assembled loss trajectory must equal an uninterrupted run of the
    same program in this process, bit for bit, and every run must have
    launched the same kernels.  ``result`` (a dict) receives the
    figures."""
    import json

    import torch

    from .. import disable_static, enable_static, set_device, static
    from ..core.flags import get_flag, set_flags
    from ..distributed.supervisor import (StepWatchdog, SupervisorGaveUp,
                                          TrainingSupervisor)
    from ..ops.cuda import support
    from ..utils import monitor

    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="chaos_supervise_")
    out = result if result is not None else {}
    problems = []
    fault_spec = {
        0: (f"executor.grads:action=corrupt,mode=nan,count=1,"
            f"after={nan_run - 1};executor.step_hang:count=1,"
            f"after={hang_run - 1},action=sleep,secs=600"),
        1: f"executor.run:count=1,after={crash_after},action=exit,code=7",
    }

    def child_env(attempt):
        return {"FLAGS_fault_spec": fault_spec.get(attempt, "")}

    sentry_was = get_flag("anomaly_sentry")
    try:
        # -- reference: the uninterrupted run, sentry off ------------------
        set_device(device)
        enable_static()
        set_flags({"anomaly_sentry": False})
        main, loss, feed = _drill_program(model, device)
        exe = static.Executor(device)
        support.reset_launch_counts()
        t0 = time.perf_counter()
        ref = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
               for _ in range(steps)]
        out["reference_s"] = time.perf_counter() - t0
        per_run = {k: v // steps for k, v in support.launch_counts.items()}
        predicted = next(iter(exe._cache.values())).predicted or {}
        exe.close()
        del exe, main, loss, feed
        static.reset_default_programs()
        if device != "cpu":
            torch.cuda.empty_cache()
        out["reference_losses"] = ref
        out["launches_per_run"] = per_run
        out["predicted_step_s"] = predicted.get("predicted_step_s")

        # -- the supervised run ----------------------------------------------
        monitor.stat_reset()
        watchdog = StepWatchdog(multiplier=8.0,
                                min_deadline_s=min_deadline_s,
                                max_deadline_s=240.0)
        sv = TrainingSupervisor(
            _supervised_entry, args=(workdir, steps, save_every, model,
                                     device),
            name="chaos", watchdog=watchdog, startup_timeout_s=300.0,
            hang_grace_s=2.0, poll_s=0.1, backoff_s=0.1, backoff_max_s=1.0,
            crash_window_s=600.0, crash_budget=4, child_env=child_env,
            workdir=workdir)
        t0 = time.perf_counter()
        try:
            res = sv.run()
        except SupervisorGaveUp as e:
            problems.append(f"supervisor gave up instead of healing: {e}")
            res = None
        out["supervised_s"] = time.perf_counter() - t0
        if res is not None:
            out["exit_history"] = res.exit_history
            out["watchdog_deadline_s"] = watchdog.deadline_s()
            reasons = [r["reason"] for r in res.exit_history]
            if not res.clean_exit or res.attempts != 3:
                problems.append(f"expected 3 incarnations ending "
                                f"cleanly, got {res.attempts} "
                                f"(clean={res.clean_exit})")
            if reasons[:1] != ["hang"]:
                problems.append(f"first exit {reasons[:1]} != hang")
            if len(reasons) < 2 or reasons[1] != "crash(exit=7)":
                problems.append(f"second exit {reasons[1:2]} != "
                                f"crash(exit=7)")
        stats = monitor.all_stats()
        out["supervisor_stats"] = {k: v for k, v in stats.items()
                                   if k.startswith("supervisor.")}
        for key, want in (("supervisor.hang_kills", 1),
                          ("supervisor.restarts", 2),
                          ("supervisor.starts", 3)):
            if stats.get(key, 0) != want:
                problems.append(f"{key}={stats.get(key, 0)}, want {want}")
        kill_dump = os.path.join(workdir, "supervisor_kill_a0.json")
        if not os.path.exists(kill_dump):
            problems.append("the watchdog kill left no flight dump")
        else:
            with open(kill_dump) as f:
                box = json.load(f)
            if box.get("reason") != "supervisor.hang" or (
                    box.get("extra") or {}).get("attempt") != 0:
                problems.append(f"kill flight dump: {box.get('reason')}")

        # -- the step log: a resume marker per incarnation, then its
        # runs, each with the incarnation's launches so far
        resumes, runs, last = [], [], []
        with open(os.path.join(workdir, "steps.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("event") == "resume":
                    resumes.append(rec)
                    last.append({})
                else:
                    runs.append(rec)
                    last[-1] = rec["launches"]
        out["resumes"] = resumes
        out["restart_parts"] = _restart_parts(resumes, runs)
        got = {rec["step"]: rec["loss"] for rec in runs
               if rec["action"] == "ok"}
        flagged = [rec for rec in runs if "noop" in rec]
        out["flagged_runs"] = flagged
        out["runs"] = len(runs)
        if len(resumes) != 3 or resumes[0]["step"] != 0 \
                or not 0 < resumes[1]["step"] <= resumes[2]["step"]:
            problems.append(f"resume markers {resumes}")
        if len(flagged) != 1 or not flagged[0]["noop"] \
                or flagged[0]["action"] != "skip" \
                or (flagged[0]["sentry"] or {}).get("skipped_steps") != 1:
            problems.append(f"the NaN run was not a skipped bitwise "
                            f"no-op: {flagged}")
        losses = [got.get(i) for i in range(steps)]
        out["losses"] = losses
        out["losses_equal"] = losses == ref
        if losses != ref:
            problems.append(f"supervised losses {losses} != the "
                            f"uninterrupted run's {ref}")
        total = {}
        for counts in last:
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        want = {k: v * len(runs) for k, v in per_run.items()}
        out["launches"] = total
        out["launches_want"] = want
        if total != want:
            problems.append(f"launches over the incarnations {total} != "
                            f"{len(runs)} runs x {per_run}")
    finally:
        set_flags({"anomaly_sentry": sentry_was})
        disable_static()
        static.reset_default_programs()
        if own_tmp:
            shutil.rmtree(workdir, ignore_errors=True)
    out["problems"] = problems
    if verbose:
        print(json.dumps({k: v for k, v in out.items()
                          if k not in ("exit_history",)}, default=str))
    if problems:
        for p in problems:
            print(f"FAIL: {p}", file=sys.stderr)
        return 1
    print("chaos supervise OK: a NaN step skipped as a bitwise no-op, an "
          "injected hang watchdog-killed and a crash restarted, each "
          "resuming from a step snapshot; the loss trajectory equals the "
          "uninterrupted run's")
    return 0


# ---------------------------------------------------------------------------
# Supervised training across a rank-count change: 2 gloo ranks, then 1
# ---------------------------------------------------------------------------

def _reshard_rank(workdir, steps, save_every, hb_path):
    """One rank of an incarnation's job (CPU, gloo): the fleet MLP
    data parallel over the job's ranks, resumed through
    ``TrainEpochRange`` over the Executor's reshardable
    ``sharded_state``, synchronous step snapshots.  Rank 0 stamps the
    incarnation's heartbeat and writes the step log."""
    import json

    import torch

    from .. import distributed as dist
    from .. import enable_static, set_device, static
    from ..core import obs_hook
    from ..distributed.supervisor import HeartbeatWriter
    from ..utils.checkpoint import TrainEpochRange

    torch.set_num_threads(1)
    set_device("cpu")
    dist.init_parallel_env(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        obs_hook.set_heartbeat(HeartbeatWriter(hb_path))
    enable_static()
    main, loss, feed = _drill_program("mlp", "cpu", fleet=True)
    dist.init_mesh({"dp": world})
    exe = static.Executor("cpu")
    r = TrainEpochRange(1, f"{workdir}/ckpt", save_every_steps=save_every,
                        async_publish=False, train=exe.sharded_state(main))
    log = open(f"{workdir}/steps.jsonl", "a", buffering=1) \
        if rank == 0 else None
    for _epoch in r:
        if log is not None:
            log.write(json.dumps({"event": "resume", "step": r.resume_step,
                                  "ranks": world}) + "\n")
        for step in range(r.resume_step, steps):
            val = float(exe.run(main, feed=feed, fetch_list=[loss])[0])
            if log is not None:
                log.write(json.dumps({"step": step, "loss": val,
                                      "ranks": world}) + "\n")
            r.step()
    exe.close()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _reshard_entry(workdir, steps, save_every):
    """The supervised entrypoint: start ``PADDLE_TPU_TORCH_DRILL_RANKS``
    gloo ranks of :func:`_reshard_rank` (the supervisor's ``child_env``
    sets it per attempt) and wait for them; a failed rank fails the
    incarnation."""
    from ..distributed.launch import spawn
    from ..distributed.supervisor import current_heartbeat

    n = int(os.environ.get("PADDLE_TPU_TORCH_DRILL_RANKS", "1"))
    spawn(_reshard_rank, (workdir, steps, save_every,
                          current_heartbeat().path), nprocs=n,
          timeout=600)


def supervise_reshard_main(steps=8, save_every=2, crash_after=3,
                           verbose=False, workdir=None, result=None):
    """The supervised drill's rank-count leg; returns 0 on success.  The
    first incarnation trains on 2 gloo ranks and crashes after
    ``crash_after`` runs (``executor.run`` exit on every rank); the
    restart trains on 1 rank, resuming from the 2-rank snapshot through
    the reshardable ``SnapshotStore``.  The assembled losses must equal
    an uninterrupted one-process run's within rtol 1e-5 (a dp mean of
    two slices sums in another order than the whole batch)."""
    import json

    from .. import disable_static, enable_static, set_device, static
    from ..distributed.supervisor import SupervisorGaveUp, TrainingSupervisor
    from ..utils import monitor

    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="chaos_reshard_")
    out = result if result is not None else {}
    problems = []

    def child_env(attempt):
        return {"PADDLE_TPU_TORCH_DRILL_RANKS": "2" if attempt == 0 else "1",
                "FLAGS_fault_spec": (
                    f"executor.run:count=1,after={crash_after},"
                    f"action=exit,code=7" if attempt == 0 else "")}

    try:
        set_device("cpu")
        enable_static()
        main, loss, feed = _drill_program("mlp", "cpu")
        exe = static.Executor("cpu")
        ref = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
               for _ in range(steps)]
        exe.close()
        static.reset_default_programs()
        monitor.stat_reset()
        sv = TrainingSupervisor(
            _reshard_entry, args=(workdir, steps, save_every),
            name="reshard", startup_timeout_s=300.0, poll_s=0.1,
            backoff_s=0.1, backoff_max_s=1.0, crash_window_s=600.0,
            crash_budget=3, child_env=child_env, workdir=workdir)
        try:
            res = sv.run()
            out["exit_history"] = res.exit_history
            if not res.clean_exit or res.attempts != 2:
                problems.append(f"expected 2 incarnations ending cleanly, "
                                f"got {res.attempts}")
        except SupervisorGaveUp as e:
            problems.append(f"supervisor gave up: {e}")
        resumes, got = [], {}
        with open(os.path.join(workdir, "steps.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("event") == "resume":
                    resumes.append(rec)
                else:
                    got[rec["step"]] = rec["loss"]
        out.update(resumes=resumes, reference=ref,
                   losses=[got.get(i) for i in range(steps)])
        if [r["ranks"] for r in resumes] != [2, 1] \
                or resumes[0]["step"] != 0 or resumes[1]["step"] <= 0:
            problems.append(f"resume markers {resumes}")
        if None in out["losses"] or not np.allclose(
                out["losses"], ref, rtol=1e-5, atol=0):
            problems.append(f"losses {out['losses']} != the "
                            f"uninterrupted run's {ref}")
    finally:
        disable_static()
        static.reset_default_programs()
        if own_tmp:
            shutil.rmtree(workdir, ignore_errors=True)
    out["problems"] = problems
    if verbose:
        print(json.dumps(out, default=str))
    for p in problems:
        print(f"FAIL: {p}", file=sys.stderr)
    return 1 if problems else 0


# ---------------------------------------------------------------------------
# Data-plane anomaly drill: NaN feeds, a non-finite gradient bucket, a
# corrupted int8 wire payload and a poisoned-feed burst, absorbed by the
# sentry's skips, one quarantine and one rollback
# ---------------------------------------------------------------------------

ANOMALY_CHAOS_SPEC = (
    "dataloader.batch:action=corrupt,mode=nan,count=1,match=batch=2;"
    "executor.grads:action=corrupt,mode=inf,count=1,after=6;"
    "grad_comm.wire:action=corrupt,mode=nan,count=1,after=8,"
    "tensor=*scales*;"
    "dataloader.batch:action=corrupt,mode=nan,count=3,match=batch=9;"
    "dataloader.batch:action=corrupt,mode=inf,count=1,match=batch=10")

AN_BATCH = 32          # rows per batch (divisible by every dp used)


class AnomalyDataset:
    """12 deterministic regression batches (module-level so any loader
    path can pickle it)."""

    def __init__(self, n_batches=12, batch=AN_BATCH, dim=8):
        rng = np.random.RandomState(13)
        self.x = rng.standard_normal(
            (n_batches * batch, dim)).astype(np.float32)
        self.y = (self.x @ rng.standard_normal((dim, 1))
                  ).astype(np.float32)

    def __len__(self):
        return self.x.shape[0]

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def anomaly_run(loader, exe, main, loss, steps, policy=None, store=None,
                objects=None, save_every=4, verbose=False):
    """The loop both the fault-free and the chaos runs share: batch
    ``k`` drives applied step ``k``; with a policy the loop follows its
    ladder (re-deliver on a skip, move past a quarantined batch, rewind
    to the restored step).  Returns the applied steps' losses."""
    losses = {}
    applied = cursor = 0
    while applied < steps:
        xb, yb = loader.fetch_batch(cursor)
        if policy is not None:
            policy.note_batch(cursor)
        val = float(exe.run(main, feed={"x": xb.numpy(), "y": yb.numpy()},
                            fetch_list=[loss])[0])
        act = policy.poll() if policy is not None else "ok"
        if verbose:
            print(f"  step {applied} batch {cursor}: {act} "
                  f"loss={val:.6f}")
        if act == "ok":
            losses[applied] = val
            applied += 1
            cursor += 1
            if store is not None and applied % save_every == 0 \
                    and applied < steps:
                store.save(0, objects, step=applied, kind="step")
        elif act == "skip":
            continue
        elif act == "quarantine":
            cursor += 1
        elif act == "rollback":
            applied = cursor = policy.resume_step
    return [losses[s] for s in range(steps)]


def anomaly_problems(res) -> list:
    """The drill's gates over one rank's results
    (``testing.anomaly_cases``'s ``chaos`` case): what failed, empty
    when the drill held."""
    problems = []
    got, ref = np.asarray(res["got"]), np.asarray(res["ref"])
    if got.shape != ref.shape or not np.allclose(got, ref, rtol=1e-5):
        problems.append(f"applied-step loss trajectory diverged from the "
                        f"fault-free run: {got.tolist()} vs "
                        f"{ref.tolist()}")
    if int(res["compiles"]) != 1:
        problems.append(f"the chaos run built {int(res['compiles'])}x "
                        f"(want 1)")
    if int(res["skips"]) != 5:
        problems.append(f"anomaly skips={int(res['skips'])}, expected 5 "
                        f"(NaN feed, inf grads, wire NaN, 2 burst skips)")
    if int(res["quarantines"]) != 1 or int(res["blamed"]) != 9:
        problems.append(f"quarantine ledger wrong: "
                        f"{int(res['quarantines'])} blaming batch "
                        f"{int(res['blamed'])} (expected batch 9 once)")
    if int(res["rollbacks"]) != 1 or int(res["resume_step"]) != 8:
        problems.append(f"expected 1 rollback to step 8, got "
                        f"{int(res['rollbacks'])} to "
                        f"{int(res['resume_step'])}")
    for stat, want in (("stat_skips", 5), ("stat_quarantines", 1),
                       ("stat_rollbacks", 1), ("fired_batch", 5)):
        if int(res[stat]) != want:
            problems.append(f"{stat}={int(res[stat])}, expected {want}")
    for stat in ("nonfinite_blocks", "fired_grads", "fired_wire"):
        if int(res[stat]) < 1:
            problems.append(f"{stat} never counted")
    if int(res["sentry_skipped"]) != 7:
        problems.append(f"sentry skipped_steps="
                        f"{int(res['sentry_skipped'])}, expected 7 (one "
                        f"per flagged step)")
    if float(res["param_max_rel"]) > 1e-5:
        problems.append(f"final params diverged from the fault-free run "
                        f"(max relative {float(res['param_max_rel']):.3e})")
    if str(res["flight_reason"]) != "anomaly.rollback" \
            or int(res["flight_blamed"]) != 9 \
            or int(res["flight_resume_step"]) != 8:
        problems.append(f"flight dump: reason {str(res['flight_reason'])!r},"
                        f" blamed {int(res['flight_blamed'])}, resume "
                        f"{int(res['flight_resume_step'])}")
    return problems


def anomaly_main(steps=12, save_every=4, verbose=False, workdir=None,
                 world=4, device="cpu"):
    """Data-plane fault-tolerance gate over ``world`` ranks of one
    ``torch.distributed`` job (gloo on the CPU): returns 0 on success, 1
    on failure.  Under injected NaN feeds, a non-finite gradient bucket,
    one corrupted int8 wire payload and a poisoned-feed burst, an int8
    error-feedback training run must finish with its applied-step losses
    those of the fault-free run — through in-graph sentry skips, one
    batch quarantine and one snapshot rollback, with no manual step —
    and every decision auditable from the ``anomaly.*`` stats and the
    rollback's flight dump (paddle_tpu runs it on 8 virtual devices of
    one process)."""
    from ..distributed.launch import spawn
    from . import anomaly_cases
    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="chaos_anomaly_")
    try:
        rng = np.random.RandomState(1234)
        init = [rng.standard_normal((8, 8)) * 0.3, np.zeros(8),
                rng.standard_normal((8, 1)) * 0.3, np.zeros(1)]
        np.savez(os.path.join(workdir, "inputs.npz"),
                 steps=steps, save_every=save_every,
                 **{f"p{i}": a.astype(np.float32)
                    for i, a in enumerate(init)})
        spawn(anomaly_cases.run, (workdir, ["chaos"], device),
              nprocs=world, init_method=f"file://{workdir}/store",
              timeout=600)
        problems = []
        for r in range(world):
            res = np.load(os.path.join(workdir, f"rank{r}.npz"))
            res = {k.split("/", 1)[1]: res[k] for k in res.files}
            problems += [f"rank {r}: {p}" for p in anomaly_problems(res)]
            if verbose:
                print(f"rank {r}: losses {res['got'].tolist()}")
        if problems:
            for p in problems:
                print(f"FAIL: {p}", file=sys.stderr)
            return 1
        print("chaos anomaly OK: NaN feed, inf grad bucket and a "
              "corrupted int8 wire payload were sentry-skipped "
              "(bitwise no-ops), the poisoned-feed burst was "
              "quarantined then rolled back to the step-8 snapshot, "
              "and the applied-step loss trajectory matches the "
              "fault-free run with zero manual intervention")
        return 0
    finally:
        if own_tmp:
            shutil.rmtree(workdir, ignore_errors=True)
