"""The op version registry (the counterpart of
``paddle_tpu/utils/op_version.py``; reference:
paddle/fluid/framework/op_version_registry.h).

Per-op version numbers and change notes, for humans and for
compatibility tooling: a registered version is metadata, it selects no
kernel.  A later registration of the same op keeps the earlier notes and
adds its own."""
from __future__ import annotations

from typing import Dict, List, NamedTuple

__all__ = ["OpVersion", "register_op_version", "get_op_version",
           "all_op_versions"]


class OpVersion(NamedTuple):
    version: int
    notes: List[str]


_registry: Dict[str, OpVersion] = {}


def register_op_version(op_name: str, version: int = 1,
                        note: str = "") -> OpVersion:
    prev = _registry.get(op_name)
    notes = list(prev.notes) if prev else []
    if note:
        notes.append(note)
    _registry[op_name] = OpVersion(version, notes)
    return _registry[op_name]


def get_op_version(op_name: str) -> int:
    """The op's registered version, 0 when it has none."""
    v = _registry.get(op_name)
    return v.version if v else 0


def all_op_versions() -> Dict[str, int]:
    return {k: v.version for k, v in _registry.items()}
