"""Global flags registry (the subset of ``paddle_tpu.core.flags`` that
the ported slices read).

Flags may be seeded from the environment with the ``FLAGS_`` prefix,
as in the reference's gflags passthrough.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict

__all__ = ["define_flag", "get_flag", "set_flags"]


@dataclass
class _FlagDef:
    name: str
    default: Any
    help: str
    parser: Callable[[str], Any]


_registry: Dict[str, _FlagDef] = {}
_values: Dict[str, Any] = {}
_lock = threading.Lock()


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


def define_flag(name: str, default: Any, help: str = "") -> None:
    if isinstance(default, bool):
        parser: Callable[[str], Any] = _parse_bool
    elif isinstance(default, int):
        parser = int
    elif isinstance(default, float):
        parser = float
    else:
        parser = str
    with _lock:
        _registry[name] = _FlagDef(name, default, help, parser)
        env = os.environ.get(f"FLAGS_{name}")
        if env is not None:
            _values[name] = parser(env)
        else:
            _values.setdefault(name, default)


def get_flag(name: str) -> Any:
    if name not in _registry:
        raise KeyError(f"Unknown flag: {name}")
    return _values[name]


def set_flags(flags: Dict[str, Any]) -> None:
    """paddle.set_flags parity."""
    for k, v in flags.items():
        k = k.replace("FLAGS_", "")
        if k not in _registry:
            raise KeyError(f"Unknown flag: {k}")
        with _lock:
            _values[k] = v


define_flag("use_pallas_kernels", True,
            "The hand-written kernel tier (the name is paddle_tpu's, so "
            "scripts and FLAGS_ environment variables carry across): the "
            "static Executor's epilogue-fusion pass and fused Adam, "
            "flash attention, the chunk matmul and the paged decode "
            "kernel.  On the CPU the tier runs the kernels' plain "
            "versions.")
define_flag("serving_decode_retries", 2,
            "GenerationEngine: decode-step attempts after a failure "
            "before the in-flight sequences are failed (injected faults "
            "fire before the step touches the KV pool, so they are "
            "safely retried).")
define_flag("static_verify", False,
            "Run static.analysis verification (def-use, cross-program "
            "leaks, shape/dtype drift, name collisions, dead code and "
            "the hazards) on each Program version before the Executor "
            "first builds it, and record file:line anchors for every op "
            "at record time.  Off by default: verification replays "
            "every op on meta tensors once.")
define_flag("static_anchors", False,
            "Record a file:line source anchor on every op Program.record "
            "appends (one frame walk per recorded op, no verification), "
            "so Program.analyze() reports and diagnostics carry the "
            "user's source line.")
define_flag("perf_chip", "",
            "The static/analysis/cost.CHIP_SPECS row the cost model "
            "prices a step against (the Executor's predicted record).  "
            "Empty = auto: 'h100' on an H100, else 'cpu'.")
