"""LayerNorm (paddle_tpu.nn.layer.norm): weight ones, bias zeros by
default, or as ``weight_attr`` / ``bias_attr`` say (False: none)."""
from __future__ import annotations

from ...core.placement import device as _resolve_device
from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer, create_parameter

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        dev = _resolve_device(device)
        self.weight = create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=I.Constant(1.0), device=dev)
        self.bias = create_parameter(self._normalized_shape, bias_attr,
                                     is_bias=True, device=dev)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={list(self._normalized_shape)}"
