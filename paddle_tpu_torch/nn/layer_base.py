"""``ParamAttr`` and the parameter-creation rule the layers share (the
counterparts of ``paddle_tpu.nn.layer_base.ParamAttr`` and
``Layer.create_parameter``).  The port's layers are ``torch.nn.Module``s;
the eager ``Layer`` of the JAX package is not ported here."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import initializer as I

__all__ = ["ParamAttr", "create_parameter"]


class ParamAttr:
    """How a layer makes one parameter: its ``name`` (kept as the
    parameter's ``param_name``: torch reserves ``Tensor.name``),
    ``initializer``, ``trainable`` (``requires_grad``) and ``need_clip``
    (read by the global-norm clip).  A per-parameter ``learning_rate`` other than 1
    and a ``regularizer`` are not ported and raise."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        if learning_rate != 1.0:
            raise NotImplementedError("ParamAttr: a per-parameter "
                                      "learning_rate is not ported")
        if regularizer is not None:
            raise NotImplementedError("ParamAttr: regularizer objects are "
                                      "not ported")
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> the defaults; a ParamAttr as it is; a name or an
        Initializer -> a ParamAttr holding it; False -> False (no
        parameter)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"Cannot interpret {attr!r} as ParamAttr")


def create_parameter(shape, attr=None, dtype=torch.float32, is_bias=False,
                     default_initializer=None, device=None
                     ) -> Optional[nn.Parameter]:
    """``Layer.create_parameter``'s rule: ``attr``'s initializer, else
    ``default_initializer``, else zeros for a bias and XavierNormal for a
    weight, drawn on ``device``; None when ``attr`` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_initializer or (
        I.Constant(0.0) if is_bias else I.XavierNormal())
    p = nn.Parameter(init(shape, dtype, device),
                     requires_grad=bool(attr.trainable))
    if attr.name is not None:
        p.param_name = attr.name
    if not attr.need_clip:
        p.need_clip = False
    return p
