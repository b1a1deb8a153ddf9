"""Device selection (``paddle_tpu.device``'s ``set_device`` /
``get_device``).

``set_device("cpu")`` is how a static script, or a test, asks for the
CPU: every placement that is not given ``device=`` (static parameters,
``arange``, ``static.Executor()``) then resolves to it.  ``"gpu"``,
``"gpu:1"``, ``"cuda"`` and ``"cuda:1"`` name a CUDA device and raise
without one.  Until ``set_device`` is called the default is the current
CUDA device."""
from __future__ import annotations

import torch

from .core import placement

__all__ = ["set_device", "get_device"]


def set_device(device: str) -> torch.device:
    kind, _, idx = str(device).partition(":")
    if kind in ("gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"set_device({device!r}): no CUDA device is "
                               f"available")
        dev = torch.device("cuda", int(idx) if idx else 0)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"set_device({device!r}): expected 'cpu', 'gpu', "
                         f"'gpu:N', 'cuda' or 'cuda:N'")
    placement.set_default(dev)
    return dev


def get_device() -> str:
    """``"cpu"`` or ``"gpu:N"``; raises when nothing was set and there is
    no GPU."""
    dev = placement.device(None)
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"
