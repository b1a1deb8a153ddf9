"""Stdlib HTTP front end for the serving engines (the counterpart of
``paddle_tpu/serving/http.py``).

``http.server.ThreadingHTTPServer`` gives one thread per connection, so
N concurrent connections become N waiting requests that the engines
batch: the :class:`~.engine.InferenceEngine` coalesces them into
batches, the :class:`~.generation.GenerationEngine` token by token.
Endpoints:

- ``POST /predict`` — JSON body ``{"inputs": [...], "deadline_ms": N}``
  (inputs: one array, a list of per-input arrays, or a name->array
  dict), or a raw ``.npy`` body (``Content-Type: application/x-npy``,
  single-input models; deadline via the ``X-Deadline-Ms`` header).
  JSON responses carry ``outputs``/``names``/``dtypes``; npy requests
  get the first output back as npy bytes.
- ``POST /generate`` — JSON body ``{"prompt": [ids], "max_new_tokens":
  N, "eos_id": E, "temperature": T, "seed": S, "deadline_ms": D,
  "stream": true|false}``.  With ``stream`` (the default) the response
  is ``application/x-ndjson`` over chunked transfer-encoding: one
  ``{"token": id}`` line per generated token as the scheduler produces
  it, closed by a ``{"done": true, "tokens": [...], "finish_reason":
  ...}`` summary line (errors after admission arrive in-band as an
  ``{"error": ...}`` line).  ``stream: false`` returns one JSON object
  at the end.
- ``GET /healthz`` — liveness and readiness in one probe: 200 only when
  the engine is serving and the server has been marked ready
  (:meth:`ServingServer.mark_ready`); 503 with ``Retry-After`` during
  warmup (``"warming"``), drain and close.  The body carries
  ``status`` / ``ready`` / ``weights_version``.
- ``GET /metrics`` — JSON: the inference engine's ``stats()`` (or
  ``{"counters": {}}``), with ``"generation"`` and ``"registry"`` beside
  it when those are attached.

With a :class:`~.registry.ModelRegistry` attached
(``ServingServer(registry=...)``):

- ``/predict`` and ``/generate`` route by model name or alias — the
  JSON ``"model"`` field (or the ``X-Model`` header), the registry's
  default when absent; the ``"tenant"`` field / ``X-Tenant`` header
  feeds the per-tenant quotas.
- ``GET /admin/models`` — every model's state, weights version,
  engines, in-flight count and weight, plus aliases, default and quotas.
- ``POST /admin/models`` — ``{"action": "load", "name": ..., "artifact":
  ...}`` (plus optional ``aliases``, ``weight``, ``rest_shapes``,
  ``warmup``, ``engine_kwargs``), ``"unload"``, ``"alias"`` /
  ``"unalias"``, ``"quota"`` (tenant/rate/burst), ``"weight"``,
  ``"default"``.

Every response carries an ``X-Trace-Id``: the caller's (1-64 chars of
``[A-Za-z0-9._-]``) or a fresh one.  ``/perf``, ``/admin/fleet``,
``/admin/trace`` and the Prometheus text of ``/metrics`` belong to the
observability layer (ROADMAP A4c/A7) and answer as unknown paths.

Error mapping: shed -> 503 (+Retry-After), deadline -> 504, malformed
-> 400, engine closed -> 503, unknown model -> 404, tenant over quota
-> 429 (+Retry-After).
"""
from __future__ import annotations

import concurrent.futures
import http.client as httpclient
import io
import json
import queue
import random
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, List, Optional
from urllib.parse import urlsplit

import numpy as np

from ..core import obs_hook
from ..utils import monitor
from .engine import (DeadlineExceeded, EngineClosed, InferenceEngine,
                     QueueFull, ServingError)
from .generation import GenerationEngine
from .registry import ModelRegistry, QuotaExceeded, UnknownModel

__all__ = ["ServingServer", "Client", "serve"]

_NPY = "application/x-npy"

# trace ids on the wire: 1-64 chars, alnum plus ./_/-.  Anything else
# is treated as absent (a fresh id is minted), never as an error
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._\-]{0,63}$")


def _mint_trace_id() -> str:
    return uuid.uuid4().hex


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def engine(self) -> Optional[InferenceEngine]:
        return self.server.engine

    @property
    def generation(self):
        return self.server.generation

    @property
    def registry(self) -> Optional[ModelRegistry]:
        return self.server.registry

    def log_message(self, fmt, *args):      # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    # -- distributed trace context -----------------------------------------
    def _bind_trace(self) -> str:
        """Adopt the caller's ``X-Trace-Id`` (mint a fresh one when the
        header is absent, malformed or oversized — never an error) and,
        with a tracer installed, bind it to this handler thread so the
        events emitted while handling carry it.  ``X-Parent-Span`` (the
        caller's span id) becomes the parent of this process's spans."""
        raw = self.headers.get("X-Trace-Id")
        tid = raw if (raw and _TRACE_ID_RE.match(raw)) else _mint_trace_id()
        self._trace_id = tid
        parent = self.headers.get("X-Parent-Span")
        if parent is not None and not parent.isdigit():
            parent = None           # span ids are ints; drop garbage
        trc = obs_hook._tracer
        if trc is not None:
            trc.set_trace(tid, parent)
        return tid

    def _unbind_trace(self) -> None:
        trc = obs_hook._tracer
        if trc is not None:
            trc.clear_trace()

    def _reply(self, code: int, body: bytes, ctype: str = "application/json",
               extra_headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        tid = getattr(self, "_trace_id", None)
        if tid is not None:         # echo so the caller learns minted ids
            self.send_header("X-Trace-Id", tid)
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj, extra_headers=()):
        self._reply(code, json.dumps(obj).encode(),
                    extra_headers=extra_headers)

    # -- chunked streaming (token streams) ---------------------------------
    def _start_chunked(self, code: int, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        tid = getattr(self, "_trace_id", None)
        if tid is not None:
            self.send_header("X-Trace-Id", tid)
        self.end_headers()

    def _write_chunk(self, payload: bytes) -> None:
        self.wfile.write(f"{len(payload):X}\r\n".encode() + payload
                         + b"\r\n")

    def _end_chunked(self) -> None:
        # zero-length terminator: the connection stays keep-alive
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _reply_error(self, exc: BaseException):
        kind = type(exc).__name__
        payload = {"error": kind, "message": str(exc)}
        # ordering: UnknownModel/QuotaExceeded are ServingError
        # subclasses too — match the specific routing errors first
        if isinstance(exc, UnknownModel):
            self._reply_json(404, payload)
        elif isinstance(exc, QuotaExceeded):
            self._reply_json(429, payload, [("Retry-After", "1")])
        elif isinstance(exc, QueueFull):
            self._reply_json(503, payload, [("Retry-After", "0")])
        elif isinstance(exc, (DeadlineExceeded, TimeoutError,
                              concurrent.futures.TimeoutError)):
            # concurrent.futures.TimeoutError is NOT a builtin
            # TimeoutError subclass before Python 3.11
            self._reply_json(504, payload)
        elif isinstance(exc, EngineClosed):
            self._reply_json(503, payload)
        elif isinstance(exc, (ValueError, KeyError, json.JSONDecodeError)):
            self._reply_json(400, payload)
        else:
            self._reply_json(500, payload)

    def _weights_version(self) -> int:
        for src in (self.engine, self.generation):
            if src is not None:
                return int(getattr(src, "weights_version", 0))
        return 0

    # -- routes ------------------------------------------------------------
    def do_GET(self):
        self._bind_trace()
        try:
            self._route_get()
        finally:
            self._unbind_trace()

    def _route_get(self):
        path = self.path.split("?", 1)[0]
        if path == "/admin/models":
            if self.registry is None:
                self._reply_json(501, {"error": "NotImplemented",
                                       "message": "no model registry "
                                                  "attached"})
            else:
                self._reply_json(200, self.registry.describe())
        elif path == "/healthz":
            self._do_healthz()
        elif path == "/metrics":
            stats = (self.engine.stats() if self.engine is not None
                     else {"counters": {}})
            if self.generation is not None:
                stats["generation"] = self.generation.stats()
            if self.registry is not None:
                stats["registry"] = self.registry.stats()
            self._reply_json(200, stats)
        else:
            self._reply_json(404, {"error": "NotFound", "message": self.path})

    def _do_healthz(self):
        src = self.engine if self.engine is not None else self.generation
        if src is None and self.registry is not None:
            # registry mode: alive while it routes to anything
            st = "running" if self.registry.models() else "empty"
        else:
            st = src.stats()["state"] if src is not None else "empty"
        wv = self._weights_version()
        retry = [("Retry-After", str(self.server.retry_after_s))]
        if st not in ("running", "paused"):
            # liveness gone: draining / closing / closed
            self._reply_json(503, {"status": st, "ready": False,
                                   "weights_version": wv}, retry)
        elif not self.server.ready:
            # alive but not yet warmed: hold traffic, don't restart
            self._reply_json(503, {"status": "warming",
                                   "engine_state": st, "ready": False,
                                   "weights_version": wv}, retry)
        else:
            self._reply_json(200, {"status": st, "ready": True,
                                   "weights_version": wv})

    def do_POST(self):
        tid = self._bind_trace()
        path = self.path.split("?", 1)[0]
        trc = obs_hook._tracer
        sid = None
        if trc is not None and path in ("/generate", "/predict"):
            # the HTTP-accept span: the root of this process's subtree
            # for the request — closed when the response (streaming
            # included) is fully written
            sid = trc.begin_span("http" + path.replace("/", "."),
                                 method="POST", trace=tid)
        try:
            self._route_post()
        finally:
            if sid is not None:
                trc.end_span(sid)
            self._unbind_trace()

    def _route_post(self):
        path = self.path.split("?", 1)[0]
        if path == "/generate":
            self._do_generate()
            return
        if path == "/admin/models":
            self._do_admin()
            return
        if path != "/predict":
            self._reply_json(404, {"error": "NotFound",
                                   "message": self.path})
            return
        reg = self.registry
        if reg is None and self.engine is None:
            self._reply_json(501, {"error": "NotImplemented",
                                   "message": "no inference engine "
                                              "attached"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(n)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            model = self.headers.get("X-Model")
            tenant = self.headers.get("X-Tenant")
            if ctype == _NPY:
                arr = np.load(io.BytesIO(body), allow_pickle=False)
                inputs = [arr]
                deadline_ms = self.headers.get("X-Deadline-Ms")
                deadline_ms = float(deadline_ms) if deadline_ms else None
            else:
                payload = json.loads(body or b"{}")
                if "inputs" not in payload:
                    raise ValueError('body must carry "inputs"')
                inputs = payload["inputs"]
                deadline_ms = payload.get("deadline_ms")
                model = payload.get("model") or model
                tenant = payload.get("tenant") or tenant
            timeout = self.server.request_timeout
            if reg is not None:
                # registry routing: model/alias resolution, shed flag,
                # tenant quota and WFQ share all sit in front of the
                # routed engine's own queue
                eng = reg.resolve(model).engine
                if eng is None:
                    raise UnknownModel(
                        f"model {model!r} has no inference engine")
                outs = reg.infer(model, inputs, tenant=tenant,
                                 deadline_ms=deadline_ms).result(timeout)
            else:
                eng = self.engine
                outs = eng.infer_sync(inputs, deadline_ms=deadline_ms,
                                      timeout=timeout)
        except Exception as e:              # noqa: BLE001 - mapped to HTTP
            self._reply_error(e)
            return
        if ctype == _NPY:
            buf = io.BytesIO()
            np.save(buf, outs[0], allow_pickle=False)
            self._reply(200, buf.getvalue(), ctype=_NPY)
        else:
            self._reply_json(200, {
                "outputs": [o.tolist() for o in outs],
                "names": eng._pred.get_output_names(),
                "dtypes": [str(o.dtype) for o in outs],
            })

    def _do_generate(self):
        reg = self.registry
        gen = self.generation
        if gen is None and reg is None:
            self._reply_json(501, {"error": "NotImplemented",
                                   "message": "no generation engine "
                                              "attached"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if "prompt" not in payload:
                raise ValueError('body must carry "prompt"')
            stream_mode = bool(payload.get("stream", True))
            kw = {}
            for k in ("max_new_tokens", "eos_id", "temperature", "seed",
                      "deadline_ms"):
                if payload.get(k) is not None:
                    kw[k] = payload[k]
            if reg is not None:
                model = (payload.get("model")
                         or self.headers.get("X-Model"))
                tenant = (payload.get("tenant")
                          or self.headers.get("X-Tenant"))
                s = reg.generate(model, payload["prompt"],
                                 tenant=tenant, **kw)
            else:
                s = gen.generate(payload["prompt"], **kw)
        except Exception as e:          # noqa: BLE001 - mapped to HTTP
            self._reply_error(e)
            return
        timeout = self.server.request_timeout
        if not stream_mode:
            try:
                toks = s.result(timeout=timeout)
            except Exception as e:      # noqa: BLE001 - mapped to HTTP
                self._reply_error(e)
                return
            self._reply_json(200, {"tokens": toks,
                                   "finish_reason": s.finish_reason,
                                   "sid": s.sid})
            return
        # admission succeeded: stream tokens as the scheduler emits
        # them; anything that goes wrong PAST this point arrives
        # in-band (the status line is already on the wire)
        self._start_chunked(200, "application/x-ndjson")
        try:
            try:
                for tok in s.tokens(timeout=timeout):
                    self._write_chunk(
                        json.dumps({"token": int(tok)}).encode() + b"\n")
                summary = {"done": True, "tokens": s.result(0),
                           "finish_reason": s.finish_reason,
                           "sid": s.sid}
                self._write_chunk(json.dumps(summary).encode() + b"\n")
            except Exception as e:      # noqa: BLE001 - sent in-band
                kind = ("TimeoutError" if isinstance(e, queue.Empty)
                        else type(e).__name__)
                self._write_chunk(json.dumps(
                    {"error": kind, "message": str(e)}).encode() + b"\n")
            self._end_chunked()
        except (BrokenPipeError, ConnectionError):
            pass                        # client went away mid-stream

    def _do_admin(self):
        """``POST /admin/models``: registry control actions.  Missing
        fields map to 400 (KeyError), unknown names to 404, so a fat-
        fingered admin call can never crash the data plane."""
        reg = self.registry
        if reg is None:
            self._reply_json(501, {"error": "NotImplemented",
                                   "message": "no model registry "
                                              "attached"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            p = json.loads(self.rfile.read(n) or b"{}")
            action = p.get("action")
            if action == "load":
                entry = reg.load(
                    p["name"], p["artifact"],
                    weights_dir=p.get("weights_dir"),
                    aliases=p.get("aliases", ()),
                    weight=float(p.get("weight", 1.0)),
                    warmup=bool(p.get("warmup", True)),
                    rest_shapes=p.get("rest_shapes"),
                    engine_kwargs=p.get("engine_kwargs"))
                self._reply_json(200, {"loaded": p["name"],
                                       "state": entry.state})
            elif action == "unload":
                self._reply_json(200, reg.unload(
                    p["name"], timeout=float(p.get("timeout", 30.0))))
            elif action == "alias":
                reg.alias(p["alias"], p["target"])
                self._reply_json(200, {"alias": p["alias"],
                                       "target": p["target"]})
            elif action == "unalias":
                reg.unalias(p["alias"])
                self._reply_json(200, {"unalias": p["alias"]})
            elif action == "quota":
                reg.set_quota(p["tenant"], float(p["rate"]),
                              p.get("burst"))
                self._reply_json(200, {"tenant": p["tenant"],
                                       "rate": float(p["rate"])})
            elif action == "weight":
                reg.set_weight(p["name"], float(p["weight"]))
                self._reply_json(200, {"model": p["name"],
                                       "weight": float(p["weight"])})
            elif action == "default":
                reg.set_default(p["name"])
                self._reply_json(200, {"default": p["name"]})
            else:
                raise ValueError(f"unknown admin action {action!r}")
        except Exception as e:          # noqa: BLE001 - mapped to HTTP
            self._reply_error(e)


class ServingServer:
    """Threaded HTTP server over an inference engine, a generation
    engine, a model registry, or a combination.

    ``port=0`` picks a free port (read it back via ``.port``).  The
    server owns only the HTTP layer: ``close()`` stops accepting
    connections but leaves the engines to their owner
    (``serving.serve`` closes both).  A ``GenerationEngine`` passed as
    the first argument is taken as ``generation``."""

    def __init__(self, engine: Optional[InferenceEngine] = None,
                 host: str = "127.0.0.1",
                 port: int = 8000, request_timeout: float = 60.0,
                 verbose: bool = False, generation=None,
                 ready: bool = True, retry_after_s: float = 1.0,
                 registry: Optional[ModelRegistry] = None):
        if isinstance(engine, GenerationEngine) and generation is None:
            engine, generation = None, engine
        if engine is None and generation is None and registry is None:
            raise ValueError("attach an InferenceEngine, a "
                             "GenerationEngine, a ModelRegistry, or a "
                             "combination")
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.engine = engine
        self._httpd.generation = generation
        # a registry takes over /predict + /generate routing and
        # enables the /admin/models control plane; a direct engine/
        # generation may still be attached (it serves /metrics detail)
        self._httpd.registry = registry
        self._httpd.request_timeout = request_timeout
        self._httpd.verbose = verbose
        # readiness split: ``ready=False`` lets a supervised replica
        # bind its port early (liveness probes answer) and admit
        # traffic only after warmup via mark_ready(); retry_after_s is
        # the Retry-After hint on every 503 probe
        self._httpd.ready = bool(ready)
        self._httpd.retry_after_s = retry_after_s
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def ready(self) -> bool:
        return self._httpd.ready

    def mark_ready(self) -> None:
        """Readiness gate up: warmup is done — /healthz turns 200 and
        traffic may land."""
        self._httpd.ready = True

    def mark_unready(self) -> None:
        """Readiness gate down without killing liveness: /healthz turns
        503 + Retry-After while the engine keeps finishing accepted
        work (drain windows, planned restarts)."""
        self._httpd.ready = False

    def start(self) -> "ServingServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serving-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        self._httpd.ready = False
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.close()
        return False


def serve(engine: InferenceEngine, host: str = "127.0.0.1",
          port: int = 8000, verbose: bool = True) -> None:
    """Blocking convenience: serve until KeyboardInterrupt, then drain."""
    srv = ServingServer(engine, host, port, verbose=verbose)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        engine.close()


class Client:
    """Stdlib client for the HTTP front-end, with keep-alive reuse.

    Each thread holds ONE persistent ``http.client.HTTPConnection``
    (the server speaks HTTP/1.1 with Content-Length or chunked bodies,
    so connections survive across requests) — closed-loop bench/smoke
    clients pay connection setup once, not per request.  A stale pooled
    connection (server restarted, idle timeout) is dropped and the
    request retried once on a fresh connection; ``connections_opened``
    counts physical connects across all threads (the reuse gate's
    observable).

    **Restart ride-through.**  When the FRESH connection also fails
    (refused/reset — the replica is mid-restart under a supervisor,
    not merely holding a stale socket), the client backs off once with
    jitter — honoring the server's last ``Retry-After`` hint — and
    retries on another fresh connection.  Each such recovery counts as
    ``client.reconnects`` (``self.reconnects`` + the monitor stat), so
    a supervised restart window costs a bounded delay instead of a
    hard failure.  Requests are idempotent (inference is pure,
    generation deterministic), so the replay is safe.

    503/504 responses are raised as the matching engine exceptions
    (:class:`QueueFull` / :class:`DeadlineExceeded` / ...), so a caller
    can back off on shed exactly as an in-process caller would."""

    def __init__(self, base_url: str, timeout: float = 60.0,
                 reconnect_backoff_s: float = 0.2,
                 model: Optional[str] = None,
                 tenant: Optional[str] = None,
                 trace_id: Optional[str] = None):
        # multi-model routing: ``model`` pins every request from this
        # client to one registry entry (per-call ``model=`` overrides);
        # ``tenant`` attributes them to a quota bucket.  Both are None
        # for single-model servers — the wire format is unchanged.
        self.model = model
        self.tenant = tenant
        # distributed tracing: every request carries an ``X-Trace-Id``
        # — ``trace_id`` pins one id to every request from this client;
        # None (default) mints one per request.  The id used by the
        # most recent call is kept on ``last_trace_id`` so a caller can
        # correlate its request with the fleet timeline.
        self.trace_id = trace_id
        self.last_trace_id: Optional[str] = None
        self.base_url = base_url.rstrip("/")
        u = urlsplit(self.base_url)
        if u.scheme not in ("http", ""):
            raise ValueError(f"unsupported scheme {u.scheme!r}")
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or 80
        self.timeout = timeout
        self.reconnect_backoff_s = float(reconnect_backoff_s)
        self._local = threading.local()
        self._count_lock = threading.Lock()
        self.connections_opened = 0
        self.reconnects = 0
        self._retry_after = 0.0     # last Retry-After the server sent

    # -- connection pool (one per thread) ----------------------------------
    def _conn(self) -> httpclient.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = httpclient.HTTPConnection(self._host, self._port,
                                          timeout=self.timeout)
            self._local.conn = c
            with self._count_lock:
                self.connections_opened += 1
        return c

    def _drop_conn(self) -> None:
        c = getattr(self._local, "conn", None)
        if c is not None:
            try:
                c.close()
            except Exception:
                pass
            self._local.conn = None

    def close(self) -> None:
        """Close this thread's pooled connection (other threads' pools
        close when their threads die or on their own ``close()``)."""
        self._drop_conn()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False

    def _request(self, method: str, path: str, body: Optional[bytes]
                 = None, headers: Optional[dict] = None
                 ) -> httpclient.HTTPResponse:
        """One round trip on the pooled connection; retries once on a
        stale keep-alive socket, and once more — after a jittered
        backoff that honors the server's last ``Retry-After`` — when
        the fresh connection also failed (a supervised replica
        restart; see the class docstring).  (Serving requests are
        idempotent — inference is pure and generation is deterministic
        — so the replay is safe.)  A *timeout* is never replayed: the
        server is slow, not gone, and a replay would double its work
        while masking the real condition.  The caller must fully read
        the response."""
        headers = dict(headers or {})
        last: Optional[BaseException] = None
        for attempt in (0, 1, 2):
            c = self._conn()
            try:
                c.request(method, path, body=body, headers=headers)
                return c.getresponse()
            except (httpclient.HTTPException, ConnectionError,
                    BrokenPipeError, OSError) as e:
                self._drop_conn()
                if isinstance(e, TimeoutError):
                    raise               # slow server: surface, don't replay
                last = e
                if attempt == 1:
                    # attempt 0 may have been a stale pooled socket, but
                    # attempt 1 was a FRESH connection: the replica is
                    # down (restart window) — back off once, jittered,
                    # before the final try
                    delay = max(self._retry_after,
                                self.reconnect_backoff_s)
                    time.sleep(delay * (0.5 + random.random()))
                    with self._count_lock:
                        self.reconnects += 1
                    monitor.stat_add("client.reconnects")
        raise ServingError(f"connection to {self.base_url} failed: "
                           f"{type(last).__name__}: {last}") from last

    def _finish(self, r: httpclient.HTTPResponse) -> None:
        """Keep the connection reusable — or drop it when the server
        asked to close.  Also notes any ``Retry-After`` hint (it
        floors the reconnect backoff)."""
        ra = r.getheader("Retry-After")
        if ra is not None:
            try:
                self._retry_after = float(ra)
            except (TypeError, ValueError):
                pass
        if r.will_close:
            self._drop_conn()

    def _raise_for(self, status: int, raw: bytes):
        try:
            payload = json.loads(raw.decode() or "{}")
        except Exception:
            payload = {}
        kind = payload.get("error", "")
        msg = payload.get("message", "")
        for cls in (QueueFull, DeadlineExceeded, EngineClosed,
                    UnknownModel, QuotaExceeded):
            if kind == cls.__name__:
                raise cls(msg) from None
        raise ServingError(f"HTTP {status}: {kind or ''} {msg}")

    def _route(self, body: dict, model: Optional[str],
               tenant: Optional[str]) -> dict:
        """Stamp multi-model routing fields (per-call override, then
        the client defaults) into a JSON request body."""
        m = model if model is not None else self.model
        t = tenant if tenant is not None else self.tenant
        if m is not None:
            body["model"] = m
        if t is not None:
            body["tenant"] = t
        return body

    def _trace_begin(self, path: str, headers: dict):
        """Stamp distributed-trace headers onto one logical request —
        BEFORE :meth:`_request`'s retry loop, so a reconnect replay
        (supervised replica restart) carries the SAME trace id and the
        ride-through renders as one request on the fleet timeline.
        When tracing is on in this process, a ``client<path>`` span
        opens and its id rides ``X-Parent-Span`` — the server's subtree
        hangs off it across the process hop.  Returns ``(tracer, span
        id)`` for :meth:`_trace_end` (both None when tracing is off)."""
        tid = self.trace_id or _mint_trace_id()
        self.last_trace_id = tid
        headers["X-Trace-Id"] = tid
        trc = obs_hook._tracer
        if trc is None:
            return None, None
        sid = trc.begin_span("client" + path.replace("/", "."),
                             trace=tid)
        headers["X-Parent-Span"] = str(sid)
        trc.set_trace(tid)
        return trc, sid

    @staticmethod
    def _trace_end(trc, sid) -> None:
        if trc is not None:
            trc.end_span(sid)
            trc.clear_trace()

    def _post(self, path: str, body: bytes, headers: dict) -> bytes:
        headers = dict(headers)
        trc, sid = self._trace_begin(path, headers)
        try:
            r = self._request("POST", path, body=body, headers=headers)
            raw = r.read()
            self._finish(r)
        finally:
            self._trace_end(trc, sid)
        if r.status >= 400:
            self._raise_for(r.status, raw)
        return raw

    def _get_json(self, path: str, headers: Optional[dict] = None):
        headers = dict(headers or {})
        trc, sid = self._trace_begin(path, headers)
        try:
            r = self._request("GET", path, headers=headers)
            raw = r.read()
            self._finish(r)
        finally:
            self._trace_end(trc, sid)
        if r.status >= 400:
            if path == "/healthz":      # 503 healthz still carries status
                try:
                    return json.loads(raw.decode())
                except Exception:
                    pass
            self._raise_for(r.status, raw)
        return json.loads(raw.decode())

    def predict(self, inputs, deadline_ms: Optional[float] = None,
                model: Optional[str] = None,
                tenant: Optional[str] = None) -> List[np.ndarray]:
        """JSON round trip; returns host arrays with the server dtypes.

        Wire format (unambiguous by construction): ``inputs`` is ALWAYS
        a list of per-input arrays or a name->array dict.  A bare
        ndarray argument is wrapped as the single input; a bare
        list/tuple argument is interpreted as the per-input list."""
        if isinstance(inputs, dict):
            payload = {k: np.asarray(v).tolist() for k, v in inputs.items()}
        else:
            if isinstance(inputs, np.ndarray) or not isinstance(
                    inputs, (list, tuple)):
                inputs = [inputs]
            payload = [np.asarray(a).tolist() for a in inputs]
        body = self._route({"inputs": payload}, model, tenant)
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        raw = self._post("/predict", json.dumps(body).encode(),
                         {"Content-Type": "application/json"})
        res = json.loads(raw.decode())
        return [np.asarray(o, dtype=np.dtype(dt))
                for o, dt in zip(res["outputs"], res["dtypes"])]

    def predict_npy(self, arr: np.ndarray,
                    deadline_ms: Optional[float] = None,
                    model: Optional[str] = None,
                    tenant: Optional[str] = None) -> np.ndarray:
        buf = io.BytesIO()
        np.save(buf, np.asarray(arr), allow_pickle=False)
        headers = {"Content-Type": _NPY}
        if deadline_ms is not None:
            headers["X-Deadline-Ms"] = str(deadline_ms)
        # npy bodies have no JSON envelope: routing rides the headers
        m = model if model is not None else self.model
        t = tenant if tenant is not None else self.tenant
        if m is not None:
            headers["X-Model"] = m
        if t is not None:
            headers["X-Tenant"] = t
        raw = self._post("/predict", buf.getvalue(), headers)
        return np.load(io.BytesIO(raw), allow_pickle=False)

    def healthz(self) -> dict:
        return self._get_json("/healthz")

    def metrics(self) -> dict:
        return self._get_json("/metrics")

    # -- generation --------------------------------------------------------
    def _generate_body(self, prompt, stream: bool, kw: dict,
                       model: Optional[str] = None,
                       tenant: Optional[str] = None) -> bytes:
        body = {"prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
                "stream": stream}
        body.update({k: v for k, v in kw.items() if v is not None})
        return json.dumps(self._route(body, model, tenant)).encode()

    def generate(self, prompt, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0,
                 deadline_ms: Optional[float] = None,
                 model: Optional[str] = None,
                 tenant: Optional[str] = None) -> List[int]:
        """Blocking generation; returns the full token list."""
        raw = self._post("/generate", self._generate_body(
            prompt, False, {"max_new_tokens": max_new_tokens,
                            "eos_id": eos_id, "temperature": temperature,
                            "seed": seed, "deadline_ms": deadline_ms},
            model, tenant),
            {"Content-Type": "application/json"})
        return list(json.loads(raw.decode())["tokens"])

    def generate_stream(self, prompt, max_new_tokens: int = 32,
                        eos_id: Optional[int] = None,
                        temperature: float = 0.0, seed: int = 0,
                        deadline_ms: Optional[float] = None,
                        model: Optional[str] = None,
                        tenant: Optional[str] = None
                        ) -> Iterator[int]:
        """Yield tokens as the server streams them (chunked NDJSON).

        In-band server errors re-raise as the matching engine
        exceptions.  Abandoning the iterator mid-stream drops the
        pooled connection (it would otherwise carry unread chunks)."""
        headers = {"Content-Type": "application/json"}
        trc, sid = self._trace_begin("/generate", headers)
        try:
            r = self._request("POST", "/generate", self._generate_body(
                prompt, True, {"max_new_tokens": max_new_tokens,
                               "eos_id": eos_id,
                               "temperature": temperature,
                               "seed": seed, "deadline_ms": deadline_ms},
                model, tenant),
                headers)
            if r.status >= 400:
                raw = r.read()
                self._finish(r)
                self._raise_for(r.status, raw)
            done = False
            try:
                while True:
                    line = r.readline()
                    if not line:
                        break
                    msg = json.loads(line.decode())
                    if "token" in msg:
                        yield int(msg["token"])
                    elif "error" in msg:
                        self._raise_for(200, line)
                    if msg.get("done"):
                        break
                # drain the terminating chunk so the socket is clean
                while r.readline():
                    pass
                done = True
            finally:
                if done:
                    self._finish(r)
                else:       # abandoned/errored mid-stream: unread data
                    self._drop_conn()
        finally:
            self._trace_end(trc, sid)

    # -- model registry admin ----------------------------------------------
    def _admin(self, payload: dict) -> dict:
        raw = self._post("/admin/models", json.dumps(payload).encode(),
                         {"Content-Type": "application/json"})
        return json.loads(raw.decode())

    def admin_models(self) -> dict:
        """``GET /admin/models``: states, versions, engines, aliases,
        in-flight counts, quotas."""
        return self._get_json("/admin/models")

    def load_model(self, name: str, artifact: str, **kw) -> dict:
        """Load + warm an artifact under ``name``; extra kwargs pass
        through to :meth:`ModelRegistry.load` (``weights_dir``,
        ``aliases``, ``weight``, ``rest_shapes``, ...)."""
        return self._admin({"action": "load", "name": name,
                            "artifact": artifact, **kw})

    def unload_model(self, name: str, timeout: float = 30.0) -> dict:
        """Unload ``name``; returns the drain/page-pool summary."""
        return self._admin({"action": "unload", "name": name,
                            "timeout": timeout})

    def alias_model(self, alias: str, target: str) -> dict:
        return self._admin({"action": "alias", "alias": alias,
                            "target": target})

    def set_quota(self, tenant: str, rate: float,
                  burst: Optional[float] = None) -> dict:
        return self._admin({"action": "quota", "tenant": tenant,
                            "rate": rate, "burst": burst})
