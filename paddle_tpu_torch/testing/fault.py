"""Deterministic fault injection (the part of
``paddle_tpu.testing.fault`` that the serving engines' points use).

Instrumented code calls :func:`point` at named sites::

    fault.point("serving.dispatch", f"rows={rows}", f"attempt={attempt}")

Disarmed (the default), ``point`` is one module-bool check and a
return.  Tests arm rules with :func:`arm` (or the scoped
:class:`inject`) and clear them with :func:`disarm`.  Rule grammar:
``point_glob[:key=val[,key=val]*]`` joined by ``;``.  Keys: ``p``
(fire probability, default 1), ``count`` (max fires, default
unlimited), ``after`` (skip the first N matching hits), ``exc``
(builtin exception class name, default :class:`FaultInjected`),
``msg`` (message override), ``match`` (substring that must appear in
the point's detail args), ``action`` (``raise`` | ``exit`` |
``sleep``), ``code`` (exit status for ``action=exit``) and ``secs``
(how long ``action=sleep`` blocks the calling thread before the point
returns: a short one is a latency injection, a long one a hang).  The
RNG driving ``p`` is seeded, so a chaos run replays exactly.  Every
fire counts ``fault.fired.<point>`` in :mod:`..utils.monitor`.
``FLAGS_fault_spec``, the worker re-arming and the ``corrupt`` action
belong to the rest of the module, which is not ported.
"""
from __future__ import annotations

import builtins
import fnmatch
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

from ..utils import monitor

__all__ = ["FaultInjected", "Rule", "arm", "disarm", "inject", "is_armed",
           "point", "fire_count"]

_ACTIONS = ("raise", "exit", "sleep")


class FaultInjected(RuntimeError):
    """Default exception raised by a fired injection point."""


def _resolve_exc(name: Union[str, type]) -> type:
    if isinstance(name, type):
        return name
    if name == "FaultInjected":
        return FaultInjected
    exc = getattr(builtins, name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    raise ValueError(f"fault spec: unknown exception class '{name}'")


@dataclass
class Rule:
    pattern: str
    prob: float = 1.0
    count: Optional[int] = None      # max fires; None = unlimited
    after: int = 0                   # skip the first N matching hits
    exc: Union[str, type] = "FaultInjected"
    msg: str = ""
    match: str = ""                  # substring required in detail args
    action: str = "raise"            # raise | exit | sleep
    code: int = 43                   # exit status for action=exit
    secs: float = 60.0               # how long action=sleep blocks
    hits: int = field(default=0, compare=False)
    fires: int = field(default=0, compare=False)


def parse_spec(spec: str) -> List[Rule]:
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        pattern, _, kvs = part.partition(":")
        kw = {}
        for item in kvs.split(","):
            if not item.strip():
                continue
            k, _, v = item.partition("=")
            k, v = k.strip(), v.strip()
            if k == "p":
                kw["prob"] = float(v)
            elif k == "secs":
                kw["secs"] = float(v)
            elif k in ("count", "after", "code"):
                kw[k] = int(v)
            elif k in ("exc", "msg", "match", "action"):
                kw[k] = v
            else:
                raise ValueError(f"fault spec: unknown key '{k}' in "
                                 f"'{part}'")
        rule = Rule(pattern.strip(), **kw)
        if rule.action not in _ACTIONS:
            raise ValueError(f"fault spec: action '{rule.action}' in "
                             f"'{part}' (want one of {_ACTIONS})")
        rules.append(rule)
    return rules


_lock = threading.Lock()
_armed = False          # read without the lock on the hot path
_rules: List[Rule] = []
_seed = 0
_rng = random.Random(0)


def arm(rules: Union[str, Sequence[Rule]], seed: int = 0) -> None:
    """Arm the injector with a spec string or a list of :class:`Rule`."""
    global _armed, _rules, _rng, _seed
    with _lock:
        _rules = parse_spec(rules) if isinstance(rules, str) else \
            list(rules)
        _seed = int(seed)
        _rng = random.Random(_seed)
        _armed = bool(_rules)


def disarm() -> None:
    global _armed, _rules
    with _lock:
        _armed = False
        _rules = []


def is_armed() -> bool:
    return _armed


class inject:
    """``with fault.inject("serving.dispatch:count=1"):`` -- scoped
    arming that restores the previous arm state on exit (exception or
    not)."""

    def __init__(self, rules: Union[str, Sequence[Rule]], seed: int = 0):
        self._rules = rules
        self._seed = seed

    def __enter__(self):
        self._prev = (_armed, list(_rules), _seed)
        arm(self._rules, self._seed)
        return self

    def __exit__(self, *exc_info):
        was_armed, rules, seed = self._prev
        if was_armed:
            arm(rules, seed)
        else:
            disarm()
        return False


def point(name: str, *detail) -> None:
    """A named injection site.  No-op unless the injector is armed."""
    if not _armed:
        return
    with _lock:
        rule = None
        for r in _rules:
            if not fnmatch.fnmatchcase(name, r.pattern):
                continue
            if r.match and not any(r.match in str(d) for d in detail):
                continue
            r.hits += 1
            if r.hits <= r.after:
                continue
            if r.count is not None and r.fires >= r.count:
                continue
            if r.prob < 1.0 and _rng.random() >= r.prob:
                continue
            r.fires += 1
            rule = r
            break
        if rule is None:
            return
    monitor.stat_add(f"fault.fired.{name}")
    msg = rule.msg or (f"injected fault at '{name}'"
                       + (f" ({', '.join(map(str, detail))})"
                          if detail else ""))
    if rule.action == "exit":
        os._exit(rule.code)
    if rule.action == "sleep":
        # the calling thread blocks here, then the point returns
        time.sleep(rule.secs)
        return
    raise _resolve_exc(rule.exc)(msg)


def fire_count(name: Optional[str] = None) -> int:
    """Total fires, or fires of rules whose pattern matches ``name``."""
    with _lock:
        if name is None:
            return sum(r.fires for r in _rules)
        return sum(r.fires for r in _rules
                   if fnmatch.fnmatchcase(name, r.pattern))
