"""Containers (``paddle_tpu.nn.layer.container``): ``Sequential``,
``LayerList``, ``LayerDict`` and ``ParameterList`` as :class:`Layer`s
on torch's containers.  Sublayers of a list are named ``0``, ``1``,
... as in paddle_tpu, so state-dict names match."""
from __future__ import annotations

import collections

from torch import nn

from ..layer_base import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(Layer, nn.Sequential):
    """Layers called in order: ``Sequential(l0, l1)``,
    ``Sequential(OrderedDict(name=layer))`` or ``Sequential((name,
    layer), ...)``."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            items = list(layers[0].items())
        elif layers and isinstance(layers[0], (list, tuple)):
            items = [(str(n), l) for n, l in layers]
        else:
            items = [(str(i), l) for i, l in enumerate(layers)]
        for name, layer in items:
            self.add_sublayer(name, layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return nn.ModuleList.__getitem__(self, idx)


class LayerDict(Layer, nn.ModuleDict):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.update(sublayers)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        Layer.__init__(self)
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self
