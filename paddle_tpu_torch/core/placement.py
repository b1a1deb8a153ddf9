"""Where the port's models, pools, engines and static parameters live by
default."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["device", "set_default", "default"]

# the device ``paddle_tpu_torch.device.set_device`` chose, or None for
# the current CUDA device
_default: Optional[torch.device] = None


def set_default(dev: Optional[torch.device]) -> None:
    global _default
    _default = dev


def default() -> Optional[torch.device]:
    return _default


def _from_place(place):
    """paddle's ``*Place`` objects (a class or an instance) as torch
    device names: ``CPUPlace`` is the CPU, ``CUDAPlace(i)`` and
    ``CUDAPinnedPlace`` the card (pinned memory is host memory the card
    reads, so it places on the CPU)."""
    from ..framework_compat import CPUPlace, CUDAPinnedPlace, CUDAPlace
    cls = place if isinstance(place, type) else type(place)
    if not isinstance(cls, type) or not issubclass(
            cls, (CPUPlace, CUDAPlace, CUDAPinnedPlace)):
        return place
    if issubclass(cls, (CPUPlace, CUDAPinnedPlace)):
        return "cpu"
    idx = place.device_id if not isinstance(place, type) else 0
    return f"cuda:{int(idx)}"


def device(device: Optional[Union[str, torch.device]] = None
           ) -> torch.device:
    """Resolve a placement.  ``None`` means the device ``set_device``
    chose, else the current CUDA device; it raises when no GPU is
    present instead of falling back to the CPU (pass ``device="cpu"``,
    or call ``set_device("cpu")``, to ask for the CPU explicitly)."""
    if device is None and _default is not None:
        device = _default
    device = _from_place(device)
    if device is not None:
        if isinstance(device, str) and device.startswith("gpu"):
            device = "cuda" + device[3:]       # paddle's name for it
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            if not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' requested but no CUDA "
                                   "device is available")
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: paddle_tpu_torch places models, "
            "KV pools, engines and static parameters on the GPU by "
            "default; pass device='cpu' or call set_device('cpu') to run "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
