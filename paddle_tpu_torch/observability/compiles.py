"""Recompile attribution: every compile gets a named cause (the
counterpart of ``paddle_tpu/observability/compiles.py``).

A "compile" in the port is what its layers count as a new variant: the
static Executor's step build (``Executor.compile_count``), the
Predictor's newly prepared input signature
(``num_compiled_variants()``), ``to_static``'s capture of a new input
structure, and the generation engine's new (prefill bucket | decode)
variant.  Each reports here with a structured *signature* (an ordered
dict of the cache-key components that could have forced it).  The
previous signature for the same (component, identity) is diffed
against the new one; the first changed field, in the caller's
significance order, names the cause — ``new_program_version``,
``new_feed_signature``, ``new_bucket``, ... — and the diff is kept so
:func:`explain_compiles` shows *what* changed.  A compile whose
signature matches its predecessor exactly is ``unexplained``.  The
causes keep paddle_tpu's names.

Always on: compiles are rare, so attribution is not gated behind
``observability.enable()`` — only the tracer *event* per compile is.
Each record counts ``compiles.<component>.<cause>`` and
``compiles.total`` in monitor.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..core import obs_hook
from ..utils import monitor

__all__ = ["record_compile", "explain_compiles", "reset_compiles",
           "annotate_compile"]

_MAX_RECORDS = 2048          # ring of full records; totals never drop

_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=_MAX_RECORDS)
_prev: Dict[Tuple[str, object], dict] = {}
_totals: collections.Counter = collections.Counter()


def _freeze(v):
    """Signature values must be hashable/comparable; stringify the rest."""
    if isinstance(v, (int, float, bool, str, bytes, type(None))):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(_freeze(x) for x in v))
    return repr(v)


def record_compile(component: str, identity, signature: Dict[str, object],
                   note: str = "", predicted: Optional[dict] = None,
                   kernels: Optional[List[str]] = None,
                   comm: Optional[dict] = None) -> dict:
    """Report one compile.

    ``component``: "executor" | "jit" | "predictor" | ... .
    ``identity``: what recompiles are diffed against — the program
    serial, the StaticFunction instance serial, the Predictor serial.
    ``signature``: ordered cache-key components, most significant
    first; the first field that differs from the previous compile of
    the same identity names the cause (``new_<field>``).
    ``predicted``: the static cost model's numbers for the compiled
    step (FLOPs, peak bytes — static/analysis/cost.compile_summary);
    kept on the record but deliberately OUT of the signature, so a
    cost-model change can never masquerade as a recompile cause.
    ``explain_compiles`` surfaces it next to the attribution, which is
    where predicted-vs-measured drift shows up.
    ``kernels``: the hand kernels this variant selected (the static
    step's realized fused epilogues, fused Adam) — like ``predicted``,
    on the record but OUT of the signature.
    ``comm``: a grad_comm step's bucket schedule (each bucket's size,
    algorithm, wire dtype and bytes, issue point; the overlap knob and
    the path it resolved to), on the record, out of the signature.
    Persistent-compile-cache provenance goes on through
    :func:`annotate_compile`.
    """
    sig = {k: _freeze(v) for k, v in signature.items()}
    now = time.time()
    with _lock:
        prev = _prev.get((component, identity))
        if prev is None:
            cause = "first_compile"
            changed: Dict[str, tuple] = {}
        else:
            changed = {k: (prev.get(k), v) for k, v in sig.items()
                       if prev.get(k) != v}
            if changed:
                cause = "new_" + next(k for k in sig if k in changed)
            else:
                cause = "unexplained"
        _prev[(component, identity)] = sig
        rec = {
            "time": now,
            "component": component,
            "identity": identity,
            "cause": cause,
            "changed": changed,
            "signature": sig,
        }
        if note:
            rec["note"] = note
        if predicted:
            rec["predicted"] = dict(predicted)
        if kernels:
            rec["kernels"] = list(kernels)
        if comm:
            rec["comm"] = dict(comm)
        _records.append(rec)
        _totals[(component, cause)] += 1
    monitor.stat_add(f"compiles.{component}.{cause}")
    monitor.stat_add("compiles.total")
    trc = obs_hook._tracer
    if trc is not None:
        trc.emit("compile", f"{component}.compile",
                 args={"cause": cause, "identity": str(identity),
                       "changed": sorted(changed)})
    return rec


def annotate_compile(component: str, identity, cache: str) -> bool:
    """Attach cache provenance to the NEWEST record of ``(component,
    identity)`` after the fact.  The lazily-compiling Executor records
    its compile when the cache key misses but only learns loaded-vs-
    compiled at the first dispatch — this closes that gap so
    ``explain_compiles()`` shows provenance for every site.  Returns
    False when no record matches (nothing to annotate)."""
    with _lock:
        for rec in reversed(_records):
            if (rec["component"] == component
                    and rec["identity"] == identity):
                rec["cache"] = str(cache)
                return True
    return False


def explain_compiles(component: Optional[str] = None) -> dict:
    """Why did every compile happen?

    Returns ``{"total", "unexplained", "by_cause": {"component.cause":
    n}, "records": [...]}`` — ``records`` keeps the newest
    ``_MAX_RECORDS`` full entries (cause + field-level diff), the
    totals cover the whole process lifetime.  ``component`` filters
    both."""
    with _lock:
        recs = [dict(r) for r in _records
                if component is None or r["component"] == component]
        totals = {f"{c}.{cause}": n for (c, cause), n in _totals.items()
                  if component is None or c == component}
    total = sum(totals.values())
    unexplained = sum(n for k, n in totals.items()
                      if k.endswith(".unexplained"))
    return {"total": total, "unexplained": unexplained,
            "by_cause": dict(sorted(totals.items())), "records": recs}


def reset_compiles() -> None:
    """Drop attribution history (tests / fresh smoke runs)."""
    with _lock:
        _records.clear()
        _prev.clear()
        _totals.clear()
