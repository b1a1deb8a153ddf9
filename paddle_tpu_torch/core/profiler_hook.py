"""The profiler hook shared by the op dispatch and a profiler
(``paddle_tpu.core.profiler_hook``): one module attribute, so the eager
op path pays one None check when profiling is off."""
from __future__ import annotations

from typing import Optional

__all__ = ["set_active", "current"]

_active = None


def set_active(profiler) -> None:
    global _active
    _active = profiler


def current() -> Optional[object]:
    return _active
