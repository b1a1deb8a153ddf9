"""Linear, Embedding and Dropout (paddle_tpu.nn.layer.common).

Parameters are made by ``weight_attr`` / ``bias_attr`` (a
:class:`~..layer_base.ParamAttr`, a name, an initializer, or False for
no bias), drawn on the layer's device from
``core.rng.generator(device)``.  The defaults: Linear XavierNormal over
``[in, out]`` with zero bias, Embedding N(0, 1).  ``device=None`` is
the current CUDA device (raising when there is none); pass
``device="cpu"`` for the CPU."""
from __future__ import annotations

import torch

from ...core.placement import device as _resolve_device
from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = x W + b, W: [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        dev = _resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter((in_features, out_features),
                                            weight_attr, device=dev)
        self.bias = self.create_parameter((out_features,), bias_attr,
                                          is_bias=True, device=dev)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None):
        super().__init__()
        dev = _resolve_device(device)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (None if padding_idx is None else
                             padding_idx if padding_idx >= 0 else
                             num_embeddings + padding_idx)
        self._sparse = sparse
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=I.Normal(0.0, 1.0), device=dev)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"
