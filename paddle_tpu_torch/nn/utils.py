"""Weight normalisation (paddle_tpu.nn.utils): ``weight_norm`` and
``remove_weight_norm``.

``weight_norm(layer, "weight", dim)`` takes the plain ``weight`` out of
the layer's parameters and puts two in: ``weight_g`` (the norm of
``weight`` over every axis but ``dim``, kept as size-1 axes; a scalar
when ``dim`` is None) and ``weight_v`` (``weight`` itself).  A forward
pre-hook recomputes ``weight = weight_g * weight_v / ||weight_v||``
before every forward, so gradients reach g and v through autograd.
These are paddle_tpu's names and shapes, so a weight-normed layer's
state dict carries across; torch's parametrizations would name them
otherwise.  ``remove_weight_norm`` folds them back into a plain
``weight`` parameter."""
from __future__ import annotations

import torch

from ..core.tensor import Parameter, wrap

__all__ = ["weight_norm", "remove_weight_norm"]


def _norm(v, dim):
    if dim is None:
        return torch.sqrt(torch.sum(v * v))
    axes = [i for i in range(v.dim()) if i != dim]
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def _derived(g, v, dim):
    n = _norm(v, dim)
    return (torch.reshape(g, n.shape) if dim is not None else g) * v / n


def weight_norm(layer, name="weight", dim=0):
    """Weight-normalise ``layer.<name>`` in place; returns ``layer``."""
    w = layer._parameters.get(name)
    if not isinstance(w, Parameter):
        raise ValueError(f"{name!r} is not a Parameter of {layer}")
    v0 = w.detach().clone()
    g = layer.create_parameter(tuple(_norm(v0, dim).shape), dtype=w.dtype,
                               device=w.device)
    v = layer.create_parameter(tuple(v0.shape), dtype=w.dtype,
                               device=w.device)
    with torch.no_grad():
        torch.Tensor.copy_(g, _norm(v0, dim))
        torch.Tensor.copy_(v, v0)
    del layer._parameters[name]
    setattr(layer, f"{name}_g", g)
    setattr(layer, f"{name}_v", v)
    object.__setattr__(layer, name, wrap(v0))
    layer._wn_dim = dim

    def pre_hook(lyr, inputs):
        object.__setattr__(lyr, name, wrap(_derived(
            getattr(lyr, f"{name}_g"), getattr(lyr, f"{name}_v"), dim)))

    layer._wn_hook = layer.register_forward_pre_hook(pre_hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``<name>_g`` and ``<name>_v`` back into a plain trainable
    ``layer.<name>``; returns ``layer``."""
    if f"{name}_g" not in layer._parameters:
        raise ValueError(f"{layer} has no weight_norm on {name!r}")
    with torch.no_grad():
        folded = _derived(layer._parameters[f"{name}_g"],
                          layer._parameters[f"{name}_v"], layer._wn_dim)
    layer._wn_hook.remove()
    del layer._parameters[f"{name}_g"], layer._parameters[f"{name}_v"]
    layer.__dict__.pop(name, None)
    setattr(layer, name, Parameter(folded))
    return layer
