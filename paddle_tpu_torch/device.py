"""Device selection (``paddle_tpu.device``'s ``set_device`` /
``get_device``).

``set_device("cpu")`` is how a static script, or a test, asks for the
CPU: every placement that is not given ``device=`` (static parameters,
``arange``, ``static.Executor()``) then resolves to it.  ``"gpu"``,
``"gpu:1"``, ``"cuda"`` and ``"cuda:1"`` name a CUDA device and raise
without one.  Until ``set_device`` is called the default is the current
CUDA device.

The queries answer for the card: :func:`device_count` and
:func:`get_all_devices` count CUDA devices (0 and ``[]`` without one;
the JAX package counts its CPU device), :func:`is_compiled_with_cuda`
is whether this torch was built with CUDA, and there is no TPU or XPU
build."""
from __future__ import annotations

import torch

from .core import placement

__all__ = ["set_device", "get_device", "device_count", "get_all_devices",
           "is_compiled_with_cuda", "is_compiled_with_tpu",
           "is_compiled_with_xpu"]


def device_count(kind=None) -> int:
    """CUDA devices (``kind`` None, ``"gpu"`` or ``"cuda"``); ``"cpu"``
    counts the host as one."""
    if kind == "cpu":
        return 1
    if kind not in (None, "gpu", "cuda"):
        return 0
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_all_devices():
    """``["gpu:0", ...]``, one a CUDA device."""
    return [f"gpu:{i}" for i in range(device_count())]


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


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
