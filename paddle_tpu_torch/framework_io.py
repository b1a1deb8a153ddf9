"""Weights carried across from paddle_tpu.

paddle_tpu's layers and the port's share parameter names and layouts
(``Linear.weight`` is ``[in, out]`` in both), so a paddle_tpu state
dict maps onto the port's one-to-one: a name check and a copy."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .core.placement import device as _resolve_device

__all__ = ["state_dict_from_paddle_tpu"]


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes: no numpy kernel
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def state_dict_from_paddle_tpu(
        np_state: Mapping[str, np.ndarray],
        device: Union[str, torch.device, None] = None,
        model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` from a paddle_tpu layer
    (``{k: np.asarray(v.data) for k, v in layer.state_dict().items()}``)
    -> tensors on ``device``, ready for ``load_state_dict``.  With
    ``model``, the names and shapes must be exactly the model's."""
    if model is not None:
        own = model.state_dict()
        missing = sorted(set(own) - set(np_state))
        unexpected = sorted(set(np_state) - set(own))
        if missing or unexpected:
            raise KeyError(f"state dict names differ: missing {missing}, "
                           f"unexpected {unexpected}")
        for k, v in np_state.items():
            if tuple(np.shape(v)) != tuple(own[k].shape):
                raise ValueError(f"{k}: shape {tuple(np.shape(v))}, the "
                                 f"model has {tuple(own[k].shape)}")
    dev = _resolve_device(device)
    return {k: _tensor(v).to(dev) for k, v in np_state.items()}
