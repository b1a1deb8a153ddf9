"""Continuous batching: a token-level scheduler over a paged KV cache.

:class:`GenerationEngine` schedules generation *per token*:

- **Prefill/decode phase split.**  An admitted request's prompt runs
  once through ``prefill`` (dense causal attention, K/V scattered into
  freshly reserved pages), padded to a prompt bucket, producing its
  first token; afterwards the sequence lives in a *slot* of the decode
  batch, where ONE ``decode`` step of shape ``[num_slots]`` advances
  every active sequence a token at a time over the paged cache (on the
  card through the hand-written CUDA paged-decode kernel).
- **Continuous batching.**  The scheduler admits queued requests into
  free slots *between decode steps* and evicts finished / expired
  sequences the moment they end, freeing their pages.
- **Context-width bucketing.**  The decode step's page tables are cut
  to the narrowest power-of-two width covering the longest *active*
  sequence.
- **Determinism.**  A sequence's tokens depend only on its own prompt,
  seed and temperature: per-row computation is independent of batch
  composition, page placement is invisible through the page table, and
  sampling draws come from a counter-based hash of (seed, position), so
  continuous batching reproduces bitwise regardless of admission order.

PyTorch runs eagerly, so nothing is compiled: :meth:`warmup` runs every
decode context bucket and prompt bucket once (which builds the CUDA
kernels and allocates), and ``recompiles_after_warmup`` counts
(kind, bucket) variants first run after warmup.

Robustness: bounded queue with :class:`QueueFull` shedding, in-queue
AND mid-generation deadlines (:class:`DeadlineExceeded` evicts a
decoding sequence and frees its pages), decode-step retries around
``fault.point("serving.decode_step")`` (injected faults fire before the
step touches the pool, so a retry is safe; a failure raised by the step
itself is never replayed, because the pool is updated in place — the
in-flight batch fails and the pool is zeroed), and ``drain()`` /
``close()`` that never strand a future or leak a page.

**Weights as arguments.**  The model reads the engine's serving weight
dict on every call (``params=``), so :meth:`swap_weights` is a dict
replacement committed by the scheduler between decode steps: every
sequence's next token comes from exactly one weights version.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import flags, obs_hook
from ..core.rng import M32, mul32
from ..core.placement import device as _resolve_device
from ..testing import fault
from ..utils import monitor
from .engine import (DeadlineExceeded, EngineClosed, QueueFull,
                     ServingError, _REQUEST_IDS, _mirrored_add,
                     _mirrored_observe, _safe_set_exception,
                     _safe_set_result)
from .kv_cache import KVCacheConfig, PagePool, pages_needed

_SERIALS = itertools.count(1)

__all__ = ["GenerationEngine", "GenerationStream", "GenerationError"]


class GenerationError(ServingError):
    """A sequence failed mid-generation (decode retries exhausted)."""


_DONE = object()        # stream sentinel: clean end of tokens


def gumbel_uniforms(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """[N, 2] int64 (seed, position) keys -> [N, vocab] f32 uniforms in
    [0, 1), from the murmur3-style integer mix of the JAX engine's
    ``_select_tokens``, bit for bit (uint32 arithmetic emulated in
    int64, masked after every multiply)."""
    idx = torch.arange(1, vocab + 1, dtype=torch.int64,
                       device=keys.device)[None, :]
    x = (mul32(keys[:, 0:1], 0x9E3779B1)
         ^ mul32(keys[:, 1:2], 0x85EBCA77)
         ^ mul32(idx, 0xC2B2AE3D))
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def select_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  keys: torch.Tensor) -> torch.Tensor:
    """[N, V] logits -> [N] int32 tokens (greedy or sampled).

    Sampling is a counter-based Gumbel-max draw: per-(seed, position,
    vocab-index) uniforms from :func:`gumbel_uniforms`, so a sequence's
    draws depend only on its own request state (never the slot index
    or batch composition)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    u = gumbel_uniforms(keys, logits.shape[-1])
    g = -torch.log(-torch.log(torch.clamp(u, 1e-7, 1.0 - 1e-7)))
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None] + g
    sampled = torch.argmax(scaled, dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


class GenerationStream:
    """Handle for one generation request.

    Tokens arrive incrementally via iteration (:meth:`__iter__` /
    :meth:`tokens`); the full list lands on :attr:`future` when the
    sequence finishes.  Errors (deadline, shed at eviction, decode
    failure) raise from both the iterator and ``result()``."""

    def __init__(self, sid: int):
        self.sid = sid
        self.future: Future = Future()
        self._q: "queue.Queue" = queue.Queue()
        self.finish_reason: Optional[str] = None    # "eos"|"length"|...

    def __iter__(self):
        return self.tokens()

    def tokens(self, timeout: Optional[float] = None):
        """Yield token ids as the scheduler produces them."""
        while True:
            item = self._q.get(timeout=timeout)
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block for the complete token list."""
        return self.future.result(timeout)

    # scheduler-side helpers ------------------------------------------------
    def _push(self, tok: int) -> None:
        self._q.put(tok)

    def _finish(self, tokens: List[int], reason: str) -> None:
        # resolve the future BEFORE the queue sentinel: a consumer that
        # drains tokens() and immediately calls result(0) must never
        # race a not-yet-resolved future
        self.finish_reason = reason
        _safe_set_result(self.future, list(tokens))
        self._q.put(_DONE)

    def _fail(self, exc: BaseException, reason: str) -> None:
        self.finish_reason = reason
        _safe_set_exception(self.future, exc)
        self._q.put(exc)


class _Sequence:
    """One admitted-or-queued generation request (scheduler-private)."""

    __slots__ = ("prompt", "max_new", "eos_id", "temperature", "seed",
                 "deadline", "t_enq", "t_first", "sid", "stream", "pages",
                 "slot", "tokens", "last_token", "position", "trace")

    def __init__(self, prompt, max_new, eos_id, temperature, seed,
                 deadline):
        self.prompt = prompt                  # np.int32 [T]
        self.max_new = max_new
        self.eos_id = eos_id
        self.temperature = temperature
        self.seed = seed
        self.deadline = deadline              # monotonic seconds or None
        self.t_enq = time.monotonic()
        self.t_first: Optional[float] = None
        self.sid = next(_REQUEST_IDS)
        self.stream = GenerationStream(self.sid)
        self.pages: List[int] = []
        self.slot: Optional[int] = None
        self.tokens: List[int] = []           # generated (no prompt)
        self.last_token = 0
        self.position = 0                     # total tokens in cache
        self.trace: Optional[str] = None      # distributed trace id, if
                                              # the admitting thread had one


class GenerationEngine:
    """Continuous-batching generative decode over a paged KV cache.

    Args:
        model: paged decode contract — attributes ``num_layers`` /
            ``num_kv_heads`` / ``head_dim`` (KV geometry), methods
            ``prefill(tokens[T], length, kv, page_table[P], params=)``
            -> ``(logits[V], kv)`` and ``decode(tokens[S],
            positions[S], kv, page_tables[S, P], params=)`` ->
            ``(logits[S, V], kv)``, and ``named_parameters()`` (see
            :class:`~paddle_tpu_torch.serving.models.PagedDecoderLM`).
            Its parameters must lie on ``device``.
        num_slots: decode-batch width (in-flight sequences).
        page_size: tokens per KV page.
        max_context: per-sequence token capacity (prompt + generated).
        num_pages: physical pool size; defaults to full occupancy
            (``num_slots * pages_per_seq``) so admission can never be
            page-starved below slot capacity.
        prompt_buckets: prompt pad lengths; default powers of two from
            8 up to ``max_context``.
        max_queue: bounded queue capacity; a full queue sheds.
        default_deadline_ms: deadline for requests that carry none.
        decode_retries: decode-step re-runs after an injected fault
            before the in-flight batch is failed (default
            ``FLAGS_serving_decode_retries``).
        name: engine label; monitor stats mirror under
            ``serving.engine.<name>.decode.*``.
        device: where the KV pool lives and the steps run; ``None`` is
            the current CUDA device (raising when there is none).
    """

    def __init__(self, model, num_slots: int = 8, page_size: int = 16,
                 max_context: int = 256,
                 num_pages: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 256,
                 default_deadline_ms: Optional[float] = None,
                 decode_retries: Optional[int] = None,
                 name: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.device = _resolve_device(device)
        params = {k: v.detach() for k, v in model.named_parameters()}
        wrong = sorted(k for k, v in params.items()
                       if v.device != self.device)
        if wrong:
            raise ValueError(f"model parameters {wrong[:3]} are not on "
                             f"the engine's device {self.device}")
        self._model = model
        self.name = str(name) if name else None
        self._stat_prefix = (f"serving.engine.{self.name}.decode."
                             if self.name else None)
        self._slots_n = int(num_slots)
        cfg = KVCacheConfig(
            num_layers=model.num_layers, num_kv_heads=model.num_kv_heads,
            head_dim=model.head_dim, page_size=page_size,
            num_pages=(int(num_pages) if num_pages is not None
                       else self._slots_n *
                       -(-int(max_context) // int(page_size))),
            max_context=max_context)
        self.config = cfg
        self._pool = PagePool(cfg, device=self.device)
        self._P = cfg.pages_per_seq
        if prompt_buckets is None:
            prompt_buckets, b = [], 8
            while b < cfg.max_context:
                prompt_buckets.append(b)
                b <<= 1
            prompt_buckets.append(cfg.max_context)
        self._prompt_buckets = sorted({int(b) for b in prompt_buckets})
        if self._prompt_buckets[0] < 1 \
                or self._prompt_buckets[-1] > cfg.max_context:
            raise ValueError("prompt buckets must lie in "
                             f"[1, {cfg.max_context}]")
        # page-table width buckets for the decode step: powers of two up
        # to the full per-sequence table
        self._ctx_buckets, b = [], 1
        while b < self._P:
            self._ctx_buckets.append(b)
            b <<= 1
        self._ctx_buckets.append(self._P)
        self._max_queue = int(max_queue)
        self._default_deadline = (float(default_deadline_ms) / 1000.0
                                  if default_deadline_ms is not None
                                  else None)
        self._retries = (flags.get_flag("serving_decode_retries")
                         if decode_retries is None
                         else int(decode_retries))

        # scheduler state (slots touched only by the scheduler thread)
        self._slots: List[Optional[_Sequence]] = [None] * self._slots_n
        self._tables = np.zeros((self._slots_n, self._P), np.int32)
        # device mirrors of slot state that changes only at admission/
        # eviction — uploaded once per change, not once per decode step
        # (tables keyed by context-bucket width)
        self._tables_dev: Dict[int, torch.Tensor] = {}
        self._temps = np.zeros((self._slots_n,), np.float32)
        self._temps_dev: Optional[torch.Tensor] = None
        self._zero_keys = torch.zeros((self._slots_n, 2), dtype=torch.int64,
                                      device=self.device)
        self._cv = threading.Condition(threading.Lock())
        self._queue: collections.deque = collections.deque()
        self._queued_deadlines = 0
        self._draining = False
        self._closing = False
        self._closed = False
        self._paused = False
        self._stepping = False          # a decode/prefill is in flight
        # serialises pool-touching work: the scheduler's steps and
        # warmup() on the caller's thread
        self._step_lock = threading.Lock()
        self._variants: set = set()     # (kind, bucket) run so far
        self._serial = next(_SERIALS)   # compile-attribution identity
        self._compile_count = 0
        self._warm_variants: Optional[int] = None
        # serving weights, passed to every model call (see module
        # docstring): a hot swap replaces this dict between decode steps
        self._params_dev: Dict[str, torch.Tensor] = params
        self._weights_version = 0
        self._pending_swap = None   # (params, version) staged by
        #                             swap_weights, committed by _loop

        self._c: Dict[str, Union[int, float]] = collections.defaultdict(int)
        self._occ_sum = 0.0
        self._reg = monitor.StatRegistry()
        self._thread = threading.Thread(target=self._loop,
                                        name="generation-scheduler",
                                        daemon=True)
        self._thread.start()

    # -- admission ---------------------------------------------------------
    def generate(self, prompt, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0,
                 deadline_ms: Optional[float] = None) -> GenerationStream:
        """Enqueue one prompt; returns a :class:`GenerationStream`.

        ``temperature=0`` decodes greedily; ``temperature>0`` samples
        with a key derived from ``(seed, position)`` — deterministic for
        fixed arguments regardless of batching.  Raises
        :class:`QueueFull` / :class:`EngineClosed` / ``ValueError``
        synchronously."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must carry at least one token")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = prompt.size + max_new
        if total > self.config.max_context:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"= {total} exceeds max_context={self.config.max_context}")
        if prompt.size > self._prompt_buckets[-1]:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds the largest "
                f"prompt bucket {self._prompt_buckets[-1]}")
        need = pages_needed(prompt.size, max_new, self.config.page_size)
        if need > self._pool.num_pages:
            raise ValueError(
                f"request needs {need} pages, pool holds only "
                f"{self._pool.num_pages}")
        fault.point("serving.generate", f"prompt={prompt.size}")
        deadline = None
        dl_s = (float(deadline_ms) / 1000.0 if deadline_ms is not None
                else self._default_deadline)
        if dl_s is not None:
            deadline = time.monotonic() + dl_s
        seq = _Sequence(prompt, max_new, eos_id, float(temperature),
                        int(seed), deadline)
        trc = obs_hook._tracer
        if trc is not None:
            seq.trace = trc.current_trace()
        with self._cv:
            if self._closing or self._closed or self._draining:
                raise EngineClosed("engine is draining or closed")
            if len(self._queue) >= self._max_queue:
                self._expire_queued_locked()
            if len(self._queue) >= self._max_queue:
                self._c["shed"] += 1
                self._madd("shed")
                self._emit("gen_shed", sid=seq.sid)
                raise QueueFull(
                    f"generation queue full ({self._max_queue}); retry "
                    f"with backoff")
            self._queue.append(seq)
            if seq.deadline is not None:
                self._queued_deadlines += 1
            self._c["requests"] += 1
            self._madd("requests")
            self._cv.notify_all()
        self._emit("gen_enqueue", sid=seq.sid, prompt=int(prompt.size),
                   max_new=max_new)
        return seq.stream

    def generate_sync(self, prompt, timeout: Optional[float] = None,
                      **kw) -> List[int]:
        """Blocking :meth:`generate`; returns the full token list."""
        return self.generate(prompt, **kw).result(timeout)

    # -- observability helpers ---------------------------------------------
    def _emit(self, name: str, **args) -> None:
        trc = obs_hook._tracer
        if trc is not None:
            if self.name is not None:
                args["engine"] = self.name
            trc.emit("serving", name, args=args)

    def _madd(self, suffix: str, v=1) -> None:
        """Count ``serving.decode.<suffix>`` — mirrored under this
        engine's ``serving.engine.<name>.decode.`` prefix when
        labelled."""
        _mirrored_add("serving.decode.", self._stat_prefix, suffix, v)

    def _mobs(self, suffix: str, v) -> None:
        _mirrored_observe("serving.decode.", self._stat_prefix,
                          suffix, v)

    # -- steps ---------------------------------------------------------------
    def _on_device(self):
        """Make the engine's GPU current on the calling thread."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)      # always a copy

    def _note_variant(self, kind: str, bucket: int) -> None:
        if (kind, bucket) not in self._variants:
            self._variants.add((kind, bucket))
            self._compile_count += 1
            from ..observability import record_compile
            record_compile("generation", self._serial, {
                "kind": kind, "bucket": bucket,
                "slots": self._slots_n, "pages": self._pool.num_pages,
                "page_size": self.config.page_size,
                "weights_version": self._weights_version,
            }, note="warmup" if self._warm_variants is None
                else "serve-path miss")

    def warmup(self) -> int:
        """Run every decode context bucket and prompt bucket once, on
        the scratch page (this builds the CUDA kernels).  Returns the
        variant count (baseline for ``recompiles_after_warmup``)."""
        S, dev = self._slots_n, self.device
        zeros = torch.zeros((S,), dtype=torch.int32, device=dev)
        with self._step_lock, self._on_device(), torch.no_grad():
            for b in self._ctx_buckets:
                tables = torch.zeros((S, b), dtype=torch.int32, device=dev)
                self._model.decode(zeros, zeros, self._pool.kv, tables,
                                   params=self._params_dev)
                self._note_variant("decode", b)
            table = torch.zeros((self._P,), dtype=torch.int32, device=dev)
            for b in self._prompt_buckets:
                toks = torch.zeros((b,), dtype=torch.int32, device=dev)
                self._model.prefill(toks, b, self._pool.kv, table,
                                    params=self._params_dev)
                self._note_variant("prefill", b)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self._warm_variants = self._compile_count
        return self._warm_variants

    # -- zero-downtime weight hot swap -------------------------------------
    def swap_weights(self, params, version: int,
                     timeout: Optional[float] = 30.0) -> int:
        """Atomically replace the decode weights at a step boundary.

        Validates the new parameters against the serving ones (same
        names, shapes, dtypes — a mismatch is REJECTED with
        ``ValueError``), copies them to the device off the scheduler
        thread, then stages them for the scheduler to commit between
        decode steps: every in-flight sequence finishes its current
        token on the old weights and produces its next one on the new.

        Blocks until the commit (or ``timeout`` → ``TimeoutError``);
        returns the committed version.  Call from any thread except the
        scheduler's."""
        def to_dev(v):
            t = (v.detach() if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v)))
            return t.to(self.device, copy=True)

        new = {k: to_dev(v) for k, v in params.items()}
        cur = self._params_dev
        if set(new) != set(cur):
            diff = sorted(set(cur) ^ set(new))
            raise ValueError(
                f"weight swap rejected: parameter set differs from the "
                f"serving weights (mismatched: {diff})")
        for k in sorted(new):
            if (tuple(new[k].shape) != tuple(cur[k].shape)
                    or new[k].dtype != cur[k].dtype):
                raise ValueError(
                    f"weight swap rejected: param {k!r} is "
                    f"{tuple(new[k].shape)}/{new[k].dtype}, serving "
                    f"weights are {tuple(cur[k].shape)}/{cur[k].dtype}")
        if self.device.type == "cuda":      # finish the copy HERE, off
            torch.cuda.synchronize(self.device)     # the scheduler
        with self._cv:
            if self._closing or self._closed:
                raise EngineClosed("engine is draining or closed")
            if self._pending_swap is not None:
                raise ServingError("a weight swap is already pending")
            self._pending_swap = (new, int(version))
            self._cv.notify_all()
            ok = self._cv.wait_for(
                lambda: self._pending_swap is None or self._closing
                or self._closed, timeout)
            if self._pending_swap is not None:
                self._pending_swap = None       # unstage: never commit
                if not ok:
                    raise TimeoutError(
                        f"weight swap not committed within {timeout}s")
                raise EngineClosed("engine closed before the swap "
                                   "committed")
        return int(version)

    def _commit_swap_locked(self) -> None:
        """Scheduler-side commit (caller holds the lock, between
        steps): one dict replacement, then wake the staging thread."""
        params, version = self._pending_swap
        self._pending_swap = None
        self._params_dev = params
        self._weights_version = version
        self._c["weight_swaps"] += 1
        self._madd("weight_swaps")
        self._emit("gen_weights_swap", version=version)
        self._cv.notify_all()

    @property
    def weights_version(self) -> int:
        return self._weights_version

    # -- scheduler ---------------------------------------------------------
    def _expire_queued_locked(self) -> None:
        if not self._queue or not self._queued_deadlines:
            return
        now = time.monotonic()
        alive = collections.deque()
        for s in self._queue:
            if s.deadline is not None and now > s.deadline:
                self._queued_deadlines -= 1
                self._c["deadline_expired"] += 1
                self._madd("deadline_expired")
                self._emit("gen_deadline_expired", sid=s.sid, where="queue")
                s.stream._fail(DeadlineExceeded(
                    f"deadline expired after "
                    f"{(now - s.t_enq) * 1000:.1f} ms in queue"),
                    "deadline")
            else:
                alive.append(s)
        self._queue = alive

    def _active(self) -> List[_Sequence]:
        return [s for s in self._slots if s is not None]

    def _admit_locked(self) -> List[_Sequence]:
        """Move queued requests into free slots while pages last."""
        admitted = []
        now = time.monotonic()
        for i in range(self._slots_n):
            if self._slots[i] is not None or not self._queue:
                continue
            head = self._queue[0]
            if head.deadline is not None and now > head.deadline:
                # lapsed while queued: expire instead of admitting
                self._expire_queued_locked()
                if not self._queue:
                    break
                head = self._queue[0]
            need = pages_needed(head.prompt.size, head.max_new,
                                self.config.page_size)
            pages = self._pool.alloc(need)
            if pages is None:       # pool starved: wait for an eviction
                break
            self._queue.popleft()
            if head.deadline is not None:
                self._queued_deadlines -= 1
            head.pages = pages
            head.slot = i
            self._slots[i] = head
            row = np.zeros((self._P,), np.int32)
            row[:len(pages)] = pages
            self._tables[i] = row
            self._temps[i] = head.temperature
            self._tables_dev.clear()
            self._temps_dev = None
            admitted.append(head)
            self._c["admitted"] += 1
            self._c["pages_allocated"] += need
            self._madd("admitted")
        return admitted

    def _evict_locked(self, seq: _Sequence) -> None:
        """Free a sequence's slot + pages (future/stream already
        resolved by the caller)."""
        i = seq.slot
        if i is not None and self._slots[i] is seq:
            self._slots[i] = None
            self._tables[i] = 0
            self._temps[i] = 0.0
            self._tables_dev.clear()
            self._temps_dev = None
        if seq.pages:
            self._pool.free(seq.pages)
            self._c["pages_freed"] += len(seq.pages)
            seq.pages = []
        seq.slot = None
        self._cv.notify_all()

    def _finish(self, seq: _Sequence, reason: str,
                exc: Optional[BaseException] = None) -> None:
        now = time.monotonic()
        with self._cv:
            self._evict_locked(seq)
            if exc is None:
                self._c["finished"] += 1
            else:
                self._c["failed"] += 1
        if exc is None:
            seq.stream._finish(seq.tokens, reason)
            self._madd("finished")
            lat = (now - seq.t_enq) * 1000.0
            self._reg.observe("latency_ms", lat)
            self._mobs("latency_ms", lat)
            if seq.t_first is not None and len(seq.tokens) > 1:
                tpot = ((now - seq.t_first) * 1000.0
                        / (len(seq.tokens) - 1))
                self._reg.observe("tpot_ms", tpot)
        else:
            seq.stream._fail(exc, reason)
            self._madd("failed")
        self._emit("gen_finish", sid=seq.sid, reason=reason,
                   tokens=len(seq.tokens))

    def _emit_token(self, seq: _Sequence, tok: int) -> bool:
        """Record one generated token; True when the sequence is done."""
        now = time.monotonic()
        if seq.t_first is None:
            seq.t_first = now
            self._reg.observe("ttft_ms", (now - seq.t_enq) * 1000.0)
            self._mobs("ttft_ms", (now - seq.t_enq) * 1000.0)
        seq.tokens.append(tok)
        seq.last_token = tok
        seq.stream._push(tok)
        self._c["tokens"] += 1     # monitor mirror batched by the caller
        if seq.eos_id is not None and tok == seq.eos_id:
            self._finish(seq, "eos")
            return True
        if len(seq.tokens) >= seq.max_new:
            self._finish(seq, "length")
            return True
        return False

    def _sample_key(self, seq: _Sequence) -> np.ndarray:
        # (seed, position): depends only on request-local state — never
        # on slot index or batch composition
        return np.array([seq.seed & M32, seq.position], np.int64)

    def _run_step(self, kind: str, bucket: int, step) -> torch.Tensor:
        """Run one prefill/decode step with decode-retry semantics.

        Injected faults fire before the step touches the pool and are
        always retried.  A failure raised by the step itself is NOT
        replayed: the pool was updated in place and may hold part of
        the step's writes.  The caller recovers via
        :meth:`_fail_active`."""
        self._note_variant(kind, bucket)
        last: Optional[BaseException] = None
        for attempt in range(self._retries + 1):
            try:
                fault.point("serving.decode_step", kind,
                            f"attempt={attempt}")
            except Exception as e:      # pre-step: always retryable
                last = e
                self._c["decode_errors"] += 1
                self._madd("errors")
                if attempt < self._retries:
                    self._c["decode_retries"] += 1
                    self._madd("retries")
                continue
            try:
                return step()
            except Exception as e:
                last = e
                self._c["decode_errors"] += 1
                self._madd("errors")
                break
        raise GenerationError(
            f"{kind} failed after {attempt + 1} attempts: "
            f"{type(last).__name__}: {last}") from last

    def _fail_active(self, exc: BaseException) -> None:
        """A step failed: fail every in-flight sequence, free their
        pages, and zero the KV pool — no surviving sequence's cache can
        be trusted after a partial in-place step."""
        for s in list(self._active()):
            self._finish(s, "error", exc)
        self._pool.reset_kv()

    def _prefill(self, seq: _Sequence) -> None:
        bucket = next(b for b in self._prompt_buckets
                      if b >= seq.prompt.size)
        toks = np.zeros((bucket,), np.int32)
        toks[:seq.prompt.size] = seq.prompt
        t0 = time.perf_counter()
        tokens = self._upload(toks)
        table = self._upload(self._tables[seq.slot])
        temp = torch.tensor([seq.temperature], dtype=torch.float32,
                            device=self.device)
        key = self._upload(self._sample_key(seq)[None])
        length = int(seq.prompt.size)

        def step():
            logits, _ = self._model.prefill(tokens, length, self._pool.kv,
                                            table, params=self._params_dev)
            return select_tokens(logits[None], temp, key)[0]

        try:
            tok = int(self._run_step("prefill", bucket, step))
        except GenerationError as e:
            self._fail_active(e)
            return
        self._c["prefills"] += 1
        self._c["prefill_tokens"] += length
        self._madd("prefills")
        self._madd("prefill_tokens", length)
        self._madd("tokens")
        self._emit("gen_prefill", sid=seq.sid, bucket=bucket,
                   dur_ms=(time.perf_counter() - t0) * 1000.0)
        hb = obs_hook._heartbeat
        if hb is not None:
            hb.beat(int(self._c["prefills"]))
        seq.position = length + 1
        self._emit_token(seq, tok)

    def _decode_step(self) -> None:
        S = self._slots_n
        tokens = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int32)
        sampling = False
        active = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            active.append(s)
            tokens[i] = s.last_token
            positions[i] = s.position - 1      # where this token's KV goes
            sampling = sampling or s.temperature > 0
        if not active:
            return
        t0 = time.perf_counter()
        if sampling:
            keys = np.zeros((S, 2), np.int64)
            for s in active:
                keys[s.slot] = self._sample_key(s)
            keys = self._upload(keys)
        else:       # greedy batch: keys are dead inputs, skip the upload
            keys = self._zero_keys
        # narrowest context bucket covering the longest active sequence
        page = self.config.page_size
        p_need = -(-max(s.position for s in active) // page)
        p_b = next(b for b in self._ctx_buckets if b >= p_need)
        tables = self._tables_dev.get(p_b)
        if tables is None:
            tables = self._upload(self._tables[:, :p_b])
            self._tables_dev[p_b] = tables
        if self._temps_dev is None:
            self._temps_dev = self._upload(self._temps)
        temps = self._temps_dev
        tokens_d, positions_d = self._upload(tokens), self._upload(positions)

        def step():
            logits, _ = self._model.decode(tokens_d, positions_d,
                                           self._pool.kv, tables,
                                           params=self._params_dev)
            return select_tokens(logits, temps, keys)

        try:
            toks = self._run_step("decode", p_b, step)
        except GenerationError as e:
            self._fail_active(e)
            return
        toks = toks.cpu().numpy()       # the one host sync of the step
        occ = len(active) / S
        self._c["decode_steps"] += 1
        self._occ_sum += occ
        self._madd("steps")
        self._mobs("ctx_pages", p_b)
        self._mobs("slot_occupancy", occ)
        self._mobs("page_util", self._pool.utilization())
        step_s = time.perf_counter() - t0
        self._reg.observe("step_ms", step_s * 1000.0)
        self._mobs("step_ms", step_s * 1000.0)
        hb = obs_hook._heartbeat
        if hb is not None:
            hb.beat(int(self._c["decode_steps"]))
        exp = obs_hook._export
        if exp is not None:
            exp.tick()
        if obs_hook._tracer is not None:
            traces = sorted({s.trace for s in active if s.trace})
            self._emit("gen_decode_step", sids=[s.sid for s in active],
                       n=int(self._c["decode_steps"]),
                       dur_ms=step_s * 1000.0,
                       **({"traces": traces} if traces else {}))
        p = obs_hook._perf
        if p is not None:
            p.serving_step(self.name, "decode_step", step_s)
        emitted = 0
        now = time.monotonic()
        for s in active:
            if s.deadline is not None and now > s.deadline:
                # mid-generation expiry: evict, free pages, fail cleanly
                self._c["deadline_expired"] += 1
                self._madd("deadline_expired")
                self._emit("gen_deadline_expired", sid=s.sid,
                           where="decode")
                self._finish(s, "deadline", DeadlineExceeded(
                    f"deadline expired mid-generation after "
                    f"{len(s.tokens)} tokens"))
                continue
            s.position += 1
            self._emit_token(s, int(toks[s.slot]))
            emitted += 1
        if emitted:
            self._madd("tokens", emitted)

    def _loop(self) -> None:
        with self._on_device():
            self._serve()

    def _serve(self) -> None:
        while True:
            with self._cv:
                # weight hot swap: commit between steps — one attribute
                # check when no swap is pending
                if self._pending_swap is not None:
                    self._commit_swap_locked()
                self._expire_queued_locked()
                has_active = any(s is not None for s in self._slots)
                if self._closing and not self._queue and not has_active:
                    return
                if self._paused or (not self._queue and not has_active):
                    # idle (or paused): sleep until an enqueue/resume/
                    # close notifies; poll only to sweep queued deadlines
                    self._cv.wait(
                        0.05 if (self._queued_deadlines or self._paused
                                 or self._closing) else None)
                    continue
                admitted = self._admit_locked()
                if not admitted \
                        and not any(s is not None for s in self._slots):
                    # queued work that cannot be admitted yet (page
                    # starvation) with nothing decoding: don't hot-spin
                    self._cv.wait(0.05)
                    continue
                self._stepping = True
            try:
                with self._step_lock, torch.no_grad():
                    for seq in admitted:
                        if seq.slot is not None:    # not already finished
                            self._prefill(seq)
                    self._decode_step()
            except Exception as e:      # defense in depth: the scheduler
                # must survive anything — fail in-flight work cleanly
                self._fail_active(GenerationError(
                    f"scheduler error: {type(e).__name__}: {e}"))
            finally:
                with self._cv:
                    self._stepping = False
                    self._cv.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def pause(self) -> None:
        """Testing hook: hold the scheduler between steps."""
        with self._cv:
            self._paused = True
            self._cv.notify_all()

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admission of new requests, finish everything accepted.
        Returns True when fully drained within ``timeout``."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cv:
            self._draining = True
            self._paused = False
            self._cv.notify_all()
            while (self._queue or self._stepping
                   or any(s is not None for s in self._slots)):
                wait = 0.05
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return False
                self._cv.wait(wait)
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Drain, stop the scheduler, fail anything unserved, reclaim
        every page — no stranded future, no leaked page."""
        with self._cv:
            if self._closed:
                return
            self._draining = True
            self._closing = True
            self._paused = False
            self._cv.notify_all()
        self._thread.join(timeout)
        with self._cv:
            self._closed = True
            stranded = list(self._queue)
            self._queue.clear()
            self._queued_deadlines = 0
            inflight = [s for s in self._slots if s is not None]
            stranded += inflight
            if not self._thread.is_alive():
                # scheduler is gone: reclaim in-flight sequences safely
                for s in stranded:
                    self._evict_locked(s)
            # else a wedged scheduler: futures must still resolve (pages
            # stay accounted to the wedged step — never guess)
            self._cv.notify_all()
        for s in stranded:
            s.stream._fail(EngineClosed(
                "engine closed before the sequence finished"), "closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False

    # -- observability -----------------------------------------------------
    @property
    def prompt_buckets(self) -> List[int]:
        return list(self._prompt_buckets)

    @property
    def num_slots(self) -> int:
        return self._slots_n

    @property
    def page_pool(self) -> PagePool:
        return self._pool

    def stats(self) -> Dict[str, object]:
        """Scheduler state + counters + token latency percentiles (the
        ``generation`` block of the HTTP ``/metrics`` payload)."""
        with self._cv:
            state = ("closed" if self._closed else
                     "draining" if self._draining else
                     "paused" if self._paused else "running")
            c = dict(self._c)
            queue_depth = len(self._queue)
            active = sum(1 for s in self._slots if s is not None)
            occ_sum = self._occ_sum
        steps = c.get("decode_steps", 0)
        prefill_toks = c.get("prefill_tokens", 0)
        decode_toks = c.get("tokens", 0)
        return {
            "state": state,
            "engine": self.name,
            "queue_depth": queue_depth,
            "num_slots": self._slots_n,
            "active_slots": active,
            "prompt_buckets": list(self._prompt_buckets),
            "ctx_buckets": list(self._ctx_buckets),
            "page_pool": {
                "num_pages": self._pool.num_pages,
                "page_size": self.config.page_size,
                "in_use": self._pool.in_use,
                "available": self._pool.available,
                "utilization": self._pool.utilization(),
            },
            "max_context": self.config.max_context,
            "counters": {k: c.get(k, 0) for k in (
                "requests", "admitted", "finished", "failed", "shed",
                "deadline_expired", "tokens", "prefills",
                "prefill_tokens", "decode_steps", "decode_errors",
                "decode_retries", "pages_allocated", "pages_freed",
                "weight_swaps")},
            "weights_version": self._weights_version,
            "mean_slot_occupancy": (occ_sum / steps) if steps else 0.0,
            "prefill_decode_ratio": (prefill_toks / decode_toks
                                     if decode_toks else 0.0),
            "latency_ms": self._reg.histogram_summary("latency_ms"),
            "ttft_ms": self._reg.histogram_summary("ttft_ms"),
            "step_ms": self._reg.histogram_summary("step_ms"),
            "compiled_variants": self._compile_count,
            "warm_variants": self._warm_variants,
            "recompiles_after_warmup": (
                self._compile_count - self._warm_variants
                if self._warm_variants is not None else None),
        }
