"""The dyadic models of ``paddle_tpu.testing.chaos`` and its
swap-under-fire gate's in-process leg (:func:`swap_main` with
``supervised=False``); the port's own copy.  The other chaos gates
(training preemption, resharding, anomaly, supervision, the registry
and fleet drills) are ROADMAP A5/A7's.

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

import numpy as np

__all__ = ["make_dyadic_model", "make_dyadic_lm", "swap_main"]


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

    The engines and the models live on the default device
    (``set_device``, else the current CUDA device).  Part two of
    paddle_tpu's gate (``supervised=True``: a ``ServingSupervisor``
    replica crashing mid-traffic) needs ROADMAP A5's supervisor and
    raises ``NotImplementedError``.
    """
    if supervised:
        raise NotImplementedError(
            "swap_main(supervised=True) needs the ServingSupervisor, "
            "which is ROADMAP A5's; run swap_main(supervised=False)")
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

    if own_tmp:
        shutil.rmtree(workdir, ignore_errors=True)
    if problems:
        for p in problems:
            print(f"FAIL: {p}", file=sys.stderr)
        return 1
    print("chaos swap OK: three live weight swaps applied under "
          "concurrent traffic (bitwise per version, readiness green, "
          "0 recompiles), a corrupted snapshot rejected with the old "
          "weights still serving")
    return 0
