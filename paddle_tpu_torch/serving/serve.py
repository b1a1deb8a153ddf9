"""Serve a saved inference artifact over HTTP (the counterpart of the
JAX package's ``tools/serve.py``).

Load the artifact (the prefix written by ``paddle.jit.save`` /
``paddle.static.save_inference_model``), warm up the batch buckets, and
serve::

    python -m paddle_tpu_torch.serving.serve /path/to/model_prefix --port 8000

    curl localhost:8000/healthz
    curl localhost:8000/metrics
    curl -X POST localhost:8000/predict \\
         -H 'Content-Type: application/json' \\
         -d '{"inputs": [[[0.1, 0.2, 0.3, 0.4]]]}'

``inputs`` is a list of per-input arrays (or a name->array dict), each
with a leading batch dim.  The predictor serves on the current CUDA
device; ``--device cpu`` asks for the CPU.  SIGINT/SIGTERM drain
in-flight work before exit.

The HTTP plane binds *before* warmup with readiness down: ``/healthz``
answers 503 + ``Retry-After`` (``"warming"``) until every bucket has
run once, then 200.  With ``--weights-dir`` a
:class:`~paddle_tpu_torch.serving.WeightWatcher` polls that
:class:`~paddle_tpu_torch.utils.checkpoint.SnapshotStore` directory
(every ``--weights-poll-s`` seconds) and hot-swaps newly published,
digest-verified weights into the live engine with no downtime and no
new variant.

**Multi-model mode**: ``--models manifest.json`` loads every entry of
the manifest into a :class:`~paddle_tpu_torch.serving.ModelRegistry`
(each model warms before its name becomes routable; readiness flips
when all are ready); requests route by the JSON ``"model"`` field /
``X-Model`` header, and ``/admin/models`` loads, unloads and aliases
more at runtime.  Manifest shape::

    {"models": {
        "bert": {"artifact": "/path/prefix", "aliases": ["prod"],
                 "weights_dir": "/path/snapshots",
                 "weight": 2.0, "rest_shapes": [[512]]},
        "mlp":  {"artifact": "/other/prefix"}},
     "default": "bert",
     "max_inflight": 128,
     "quotas": {"tenant-a": {"rate": 50, "burst": 100}}}
"""
from __future__ import annotations

import argparse
import json
import signal
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.serve",
        description="Serve a saved inference artifact over HTTP.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("model", nargs="?", default=None,
                    help="artifact path prefix (as passed to jit.save / "
                         "save_inference_model); omit with --models")
    ap.add_argument("--models", default=None, metavar="MANIFEST.json",
                    help="multi-model manifest (see the module docstring)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", choices=("gpu", "cpu"), default=None,
                    help="where the predictors serve (default: the "
                         "current CUDA device)")
    ap.add_argument("--max-batch-size", type=int, default=32)
    ap.add_argument("--batch-timeout-ms", type=float, default=2.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request in-queue deadline")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated batch buckets to pad to "
                         "(default: powers of two up to max batch)")
    ap.add_argument("--rest-shape", action="append", default=None,
                    metavar="D0,D1,...",
                    help="per-input shape without the batch dim, once per "
                         "input (only for symbolic non-batch dims)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up of the buckets")
    ap.add_argument("--weights-dir", default=None,
                    help="SnapshotStore directory to watch for hot-swap "
                         "weight snapshots (publish_weights); new "
                         "digest-verified versions swap in with no "
                         "downtime")
    ap.add_argument("--weights-poll-s", type=float, default=2.0,
                    help="meta-poll cadence of the weight watcher")
    ap.add_argument("--verbose", action="store_true",
                    help="log every HTTP request")
    return ap


def _on_signal(signum, frame):
    raise KeyboardInterrupt


def _install_drain_handler() -> None:
    """SIGTERM unwinds as KeyboardInterrupt (the drain path), like
    SIGINT.  A flight recorder installed after this chains to it."""
    signal.signal(signal.SIGTERM, _on_signal)


def _wait_for_signal() -> None:
    """Block until SIGINT or SIGTERM (both unwind as KeyboardInterrupt)."""
    _install_drain_handler()
    try:
        signal.pause()
    except KeyboardInterrupt:
        pass


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    from .. import set_device
    if args.device is not None:
        set_device(args.device)
    if args.models:
        return _serve_registry(args)
    if not args.model:
        ap.error("need an artifact prefix (or --models MANIFEST.json)")

    from .. import inference, serving
    predictor = inference.create_predictor(inference.Config(args.model))
    buckets = ([int(b) for b in args.buckets.split(",")]
               if args.buckets else None)
    engine = serving.InferenceEngine(
        predictor, max_batch_size=args.max_batch_size,
        batch_timeout_ms=args.batch_timeout_ms, max_queue=args.max_queue,
        default_deadline_ms=args.deadline_ms, buckets=buckets)
    # bind first, not ready: probes answer 503 "warming" while the
    # buckets run, readiness flips once the hot path is warm
    srv = serving.ServingServer(engine, host=args.host, port=args.port,
                                verbose=args.verbose, ready=False).start()
    rest = ([tuple(int(d) for d in s.split(","))
             for s in args.rest_shape] if args.rest_shape else None)
    if not args.no_warmup:
        n = engine.warmup(rest_shapes=rest)
        print(f"warmed {len(engine.buckets)} buckets {engine.buckets} -> "
              f"{n} variants on {predictor.device}", flush=True)
    srv.mark_ready()
    watcher = None
    if args.weights_dir:
        watcher = serving.WeightWatcher(
            args.weights_dir, engine=engine,
            poll_s=args.weights_poll_s, rest_shapes=rest).start()
        print(f"watching {args.weights_dir} for weight snapshots",
              flush=True)
    print(f"serving {args.model} on {srv.url}  "
          f"(POST /predict, GET /healthz, GET /metrics)", flush=True)
    try:
        _wait_for_signal()
    finally:
        print("draining...", flush=True)
        if watcher is not None:
            watcher.stop()
        srv.close()
        engine.drain(timeout=30.0)
        engine.close()
        c = engine.stats()["counters"]
        print(f"served {c['responses']}/{c['requests']} requests in "
              f"{c['batches']} batches (shed={c['shed']}, "
              f"expired={c['deadline_expired']})", flush=True)
    return 0


def _serve_registry(args) -> int:
    """--models mode: a ModelRegistry behind one HTTP plane."""
    from .. import serving

    with open(args.models) as f:
        manifest = json.load(f)
    models = manifest.get("models") or {}
    if not models:
        print(f"manifest {args.models} has no models", file=sys.stderr)
        return 2
    reg = serving.ModelRegistry(
        max_inflight=manifest.get("max_inflight"),
        default_model=manifest.get("default"))
    for tenant, q in (manifest.get("quotas") or {}).items():
        reg.set_quota(tenant, float(q["rate"]), q.get("burst"))
    srv = serving.ServingServer(None, host=args.host, port=args.port,
                                verbose=args.verbose, ready=False,
                                registry=reg).start()
    for name, spec in models.items():
        rest = ([tuple(int(d) for d in s) for s in spec["rest_shapes"]]
                if spec.get("rest_shapes") else None)
        entry = reg.load(
            name, spec["artifact"], aliases=spec.get("aliases", ()),
            weights_dir=spec.get("weights_dir"),
            weights_poll_s=float(spec.get("weights_poll_s", 2.0)),
            weight=float(spec.get("weight", 1.0)),
            warmup=not args.no_warmup, rest_shapes=rest,
            engine_kwargs={"max_batch_size": args.max_batch_size,
                           "batch_timeout_ms": args.batch_timeout_ms,
                           "max_queue": args.max_queue,
                           "default_deadline_ms": args.deadline_ms})
        print(f"loaded {name} <- {spec['artifact']} "
              f"(weight={entry.weight}, "
              f"aliases={list(spec.get('aliases', ()))})", flush=True)
    srv.mark_ready()
    print(f"serving {len(reg.models())} models {reg.models()} on "
          f"{srv.url}  (POST /predict {{\"model\": ...}}, "
          f"GET/POST /admin/models)", flush=True)
    try:
        _wait_for_signal()
    finally:
        print("draining...", flush=True)
        srv.close()
        reg.close(timeout=30.0)
        c = reg.stats()["counters"]
        print(f"routed {c['requests']} requests across {c['loads']} "
              f"loads / {c['unloads']} unloads (wfq_shed={c['wfq_shed']}, "
              f"quota_shed={c['quota_shed']}, "
              f"unknown_model={c['unknown_model']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
