"""Deterministic fault injection (the counterpart of
``paddle_tpu/testing/fault.py``).

Instrumented code calls :func:`point` at named sites::

    fault.point("serving.dispatch", f"rows={rows}", f"attempt={attempt}")

Disarmed (the default), ``point`` is one module-bool check and a
return.  Tests arm rules with :func:`arm` (or the scoped
:class:`inject`) and clear them with :func:`disarm`; operators arm them
process-wide through ``FLAGS_fault_spec`` (read from the environment
when this module is imported, or by :func:`arm_from_flags`).  Rule
grammar: ``point_glob[:key=val[,key=val]*]`` joined by ``;``.  Keys:
``p`` (fire probability, default 1), ``count`` (max fires, default
unlimited), ``after`` (skip the first N matching hits), ``exc``
(builtin exception class name, default :class:`FaultInjected`), ``msg``
(message override), ``match`` (substring that must appear in the
point's detail args), ``action`` (``raise`` | ``exit`` | ``sleep`` |
``corrupt``), ``code`` (exit status for ``action=exit``), ``secs`` (how
long ``action=sleep`` blocks the calling thread before the point
returns: a short one is a latency injection, a long one a hang only a
supervisor's watchdog clears) and ``respawn`` (1 = the rule survives
into the children :func:`spec_for_children` re-arms with
``respawn=True``).

Data corruption (``action=corrupt``): the point poisons the payload
flowing through it instead of raising.  ``mode`` picks the corruption
(``nan`` | ``inf`` | ``bitflip``; an integer payload always takes the
bitflip), ``n`` how many leading elements are hit (default 1), and
``tensor`` a glob on the tensor's label (``tensor=*scales*`` hits only
the int8 block scales of a quantized wire payload).  Two kinds of
corruption point:

- host points call :func:`corrupt_host` on a numpy/Tensor tree, with
  the full ``p``/``count``/``after``/``match`` hit accounting;
- in-step points (``executor.grads``, ``grad_comm.wire``) call
  :func:`corrupt_in_graph` on a tensor inside the Executor's step, at
  the program's run counter: the rule's ``after``/``count`` are a run
  window (``after < run <= after + count``) and ``p`` a draw keyed on
  the fault seed, the site, the rule and the run, so a fire replays.
  The Executor lists its sites with :func:`graph_corrupt_sites` when
  it builds a step (the arm state then is the one that counts), and
  :func:`mirror_graph_fires` keeps ``fault.fired.<point>`` and the
  rules' fire counts equal to the fires the step took.

The RNG driving ``p`` is seeded (``seed=`` / ``FLAGS_fault_seed``), so
a chaos run replays exactly.  Every fire counts ``fault.fired.<point>``
in :mod:`..utils.monitor` and, with a tracer installed, lands on it as
a ``fault`` event.
"""
from __future__ import annotations

import builtins
import fnmatch
import os
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

from ..utils import monitor

__all__ = ["FaultInjected", "Rule", "arm", "disarm", "inject", "is_armed",
           "point", "fire_count", "spec_for_children", "arm_from_flags",
           "corrupt_host", "corrupt_in_graph", "corrupt_rules",
           "graph_corrupt_sites", "mirror_graph_fires"]

_ACTIONS = ("raise", "exit", "sleep", "corrupt")
_MODES = ("nan", "inf", "bitflip")


class FaultInjected(RuntimeError):
    """Default exception raised by a fired injection point."""


def _resolve_exc(name: Union[str, type]) -> type:
    if isinstance(name, type):
        return name
    if name == "FaultInjected":
        return FaultInjected
    if name == "CheckpointError":
        from ..utils.checkpoint import CheckpointError
        return CheckpointError
    if name in ("TransientFSError", "PermanentFSError"):
        from ..utils import fs
        return getattr(fs, name)
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
    action: str = "raise"            # raise | exit | sleep | corrupt
    code: int = 43                   # exit status for action=exit
    secs: float = 60.0               # how long action=sleep blocks
    respawn: bool = False            # survive into respawned children
    mode: str = "nan"                # corrupt: nan | inf | bitflip
    n: int = 1                       # corrupt: leading elements poisoned
    tensor: str = ""                 # corrupt: glob on the tensor label
    hits: int = field(default=0, compare=False)
    fires: int = field(default=0, compare=False)

    def to_spec(self) -> str:
        kv = []
        if self.prob != 1.0:
            kv.append(f"p={self.prob}")
        if self.count is not None:
            kv.append(f"count={self.count}")
        if self.after:
            kv.append(f"after={self.after}")
        exc_name = self.exc if isinstance(self.exc, str) else \
            self.exc.__name__
        if exc_name != "FaultInjected":
            kv.append(f"exc={exc_name}")
        if self.msg:
            kv.append(f"msg={self.msg}")
        if self.match:
            kv.append(f"match={self.match}")
        if self.action != "raise":
            kv.append(f"action={self.action}")
        if self.code != 43:
            kv.append(f"code={self.code}")
        if self.secs != 60.0:
            kv.append(f"secs={self.secs}")
        if self.respawn:
            kv.append("respawn=1")
        if self.mode != "nan":
            kv.append(f"mode={self.mode}")
        if self.n != 1:
            kv.append(f"n={self.n}")
        if self.tensor:
            kv.append(f"tensor={self.tensor}")
        return self.pattern + (":" + ",".join(kv) if kv else "")


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
            elif k in ("count", "after", "code", "n"):
                kw[k] = int(v)
            elif k == "respawn":
                kw["respawn"] = v not in ("0", "false", "")
            elif k in ("exc", "msg", "match", "action", "mode", "tensor"):
                kw[k] = v
            else:
                raise ValueError(f"fault spec: unknown key '{k}' in "
                                 f"'{part}'")
        rule = Rule(pattern.strip(), **kw)
        if rule.action not in _ACTIONS:
            raise ValueError(f"fault spec: action '{rule.action}' in "
                             f"'{part}' (want one of {_ACTIONS})")
        if rule.action == "corrupt" and rule.mode not in _MODES:
            raise ValueError(f"fault spec: corrupt mode '{rule.mode}' in "
                             f"'{part}' (want nan | inf | bitflip)")
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


def _take(name: str, detail: Tuple, corrupt: bool,
          tensor: str = "") -> Optional[Rule]:
    """The first armed rule of the kind that fires at this hit, with
    its hit accounting done (under the lock)."""
    with _lock:
        for r in _rules:
            if (r.action == "corrupt") != corrupt:
                continue
            if not fnmatch.fnmatchcase(name, r.pattern):
                continue
            if corrupt and r.tensor and not fnmatch.fnmatchcase(
                    tensor, r.tensor):
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
            return r
    return None


def _record_fire(name: str, args: dict) -> None:
    monitor.stat_add(f"fault.fired.{name}")
    from ..core import obs_hook
    trc = obs_hook._tracer
    if trc is not None:
        # the fire lands on the trace BEFORE the raise/exit, so a crash
        # flight dump always shows the injected fault that caused it
        trc.emit("fault", name, args=args)


def point(name: str, *detail) -> None:
    """A named injection site.  No-op unless the injector is armed."""
    if not _armed:
        return
    rule = _take(name, detail, corrupt=False)
    if rule is None:
        return
    _record_fire(name, {"detail": [str(d) for d in detail],
                        "action": rule.action})
    msg = rule.msg or (f"injected fault at '{name}'"
                       + (f" ({', '.join(map(str, detail))})"
                          if detail else ""))
    if rule.action == "exit":
        os._exit(rule.code)
    if rule.action == "sleep":
        # a real wedge: SIGTERM handlers run but the sleep resumes
        # (PEP 475), so only SIGKILL, or the sleep expiring, ends it
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


def spec_for_children(respawn: bool = False) -> Optional[Tuple[str, int]]:
    """Serialized ``(spec, seed)`` to re-arm a child process, or None.
    ``respawn=True`` keeps only the rules marked ``respawn=1`` (by
    default a kill rule fires in the first generation of children and
    their replacements run clean)."""
    with _lock:
        if not _armed:
            return None
        rules = [r for r in _rules if r.respawn] if respawn else _rules
        if not rules:
            return None
        return ";".join(r.to_spec() for r in rules), _seed


def arm_from_flags() -> bool:
    """Arm from ``FLAGS_fault_spec`` / ``FLAGS_fault_seed`` (set with
    ``set_flags`` or in the environment).  Returns the armed state."""
    from ..core import flags
    spec = flags.get_flag("fault_spec")
    if spec:
        arm(spec, seed=flags.get_flag("fault_seed"))
    return _armed


# ---------------------------------------------------------------------------
# Data corruption (action=corrupt): host trees and in-step tensors
# ---------------------------------------------------------------------------

def _corrupt_np(a, mode: str, n: int):
    """Poison the first ``n`` elements of a numpy array (a copy; the
    caller's array is never changed)."""
    import numpy as np
    a = np.array(a, copy=True)
    flat = a.reshape(-1)
    k = max(1, min(int(n), flat.shape[0]))
    if mode in ("nan", "inf") and not np.issubdtype(a.dtype, np.floating):
        mode = "bitflip"     # integer payloads have no NaN: flip bits
    if mode == "nan":
        flat[:k] = np.nan
    elif mode == "inf":
        flat[:k] = np.inf
    else:
        nbits = 8 * a.dtype.itemsize
        u = flat[:k].view(np.dtype(f"u{a.dtype.itemsize}"))
        # a high bit (exponent territory for floats): the poison stays
        # finite but lands far outside the healthy value range
        u ^= np.asarray(1 << (nbits - 2), dtype=u.dtype)
    return a


_INT_VIEW = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def _corrupt_tensor(x, mode: str, n: int):
    """The tensor version of :func:`_corrupt_np`: a poisoned copy."""
    import torch
    out = x.detach().clone()
    flat = out.reshape(-1)
    k = max(1, min(int(n), flat.numel()))
    if mode in ("nan", "inf") and not out.is_floating_point():
        mode = "bitflip"
    if mode == "nan":
        flat[:k] = float("nan")
    elif mode == "inf":
        flat[:k] = float("inf")
    else:
        size = out.element_size()
        u = flat[:k].view(getattr(torch, _INT_VIEW[size]))
        u ^= 1 << (8 * size - 2)
    return out


def corrupt_host(name: str, tree, *detail, tensor: str = ""):
    """Apply the first armed ``action=corrupt`` rule matching ``name``
    (and ``tensor``/``match``) to a host-side batch tree, with the full
    ``p``/``count``/``after`` hit accounting.  numpy arrays, tensors and
    nested tuple/list/dict leaves are supported; the corrupted tree is a
    copy.  Identity when disarmed."""
    if not _armed:
        return tree
    rule = _take(name, detail, corrupt=True, tensor=tensor)
    if rule is None:
        return tree
    _record_fire(name, {"detail": [str(d) for d in detail],
                        "action": "corrupt", "mode": rule.mode})

    def walk(x):
        import numpy as np
        import torch
        if isinstance(x, torch.Tensor):
            return _corrupt_tensor(x, rule.mode, rule.n)
        if isinstance(x, np.ndarray):
            return _corrupt_np(x, rule.mode, rule.n)
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x
    return walk(tree)


def corrupt_rules(name: str, tensor: str = "") -> List[Rule]:
    """Armed ``action=corrupt`` rules matching an in-step corruption
    site (no hit accounting: such rules fire on their run window)."""
    if not _armed:
        return []
    with _lock:
        return [r for r in _rules
                if r.action == "corrupt"
                and fnmatch.fnmatchcase(name, r.pattern)
                and (not r.tensor or fnmatch.fnmatchcase(tensor, r.tensor))]


def _fires_at(name: str, tensor: str, rule: Rule, step: int) -> bool:
    """Whether an in-step rule fires at run ``step``: inside its window
    and, for ``p < 1``, a draw keyed on (fault seed, site, rule, run),
    which :func:`corrupt_in_graph` and the mirror both compute."""
    step = int(step)
    if step <= rule.after:
        return False
    if rule.count is not None and step > rule.after + rule.count:
        return False
    if rule.prob >= 1.0:
        return True
    base = zlib.crc32(f"{name}|{tensor}|{rule.to_spec()}".encode())
    key = (_seed ^ base) & 0x7fffffff
    return random.Random(f"{key}:{step}").random() < rule.prob


def corrupt_in_graph(name: str, x, step, tensor: str = ""):
    """In-step corruption site: ``x`` (a tensor), or a poisoned copy of
    it when an armed corrupt rule matches and fires at run ``step`` (the
    program's 1-based run counter).  With nothing armed, ``x`` itself."""
    rules = corrupt_rules(name, tensor)
    for rule in rules:
        if _fires_at(name, tensor, rule, step):
            x = _corrupt_tensor(x, rule.mode, rule.n)
    return x


def graph_corrupt_sites(points) -> List[tuple]:
    """``[(point, tensor_label, rule)]`` for every in-step site with an
    armed corrupt rule: the Executor computes it when it builds a step,
    for :func:`mirror_graph_fires`."""
    out = []
    for name, tensor in points:
        for r in corrupt_rules(name, tensor):
            out.append((name, tensor, r))
    return out


def mirror_graph_fires(sites, step: int) -> None:
    """Host accounting of the in-step fires at run ``step``: for each
    site, the same predicate :func:`corrupt_in_graph` took, then the
    rule's fire count, ``fault.fired.<point>`` and the tracer event."""
    for name, tensor, rule in sites or ():
        if not _fires_at(name, tensor, rule, step):
            continue
        with _lock:
            rule.fires += 1
        _record_fire(name, {"detail": [tensor, f"step={step}"],
                            "action": "corrupt", "mode": rule.mode,
                            "in_graph": True})


# a chaos run armed from the environment (FLAGS_fault_spec=... python
# train.py) works before anything imports core.flags
_env_spec = os.environ.get("FLAGS_fault_spec")
if _env_spec:
    arm(_env_spec, seed=int(os.environ.get("FLAGS_fault_seed", "0")))
