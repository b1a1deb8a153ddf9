"""LayerList (paddle_tpu.nn.layer.container), on ``nn.ModuleList``: its
sublayers are named ``0``, ``1``, ... as in paddle_tpu."""
from __future__ import annotations

from torch import nn

__all__ = ["LayerList"]


class LayerList(nn.ModuleList):
    pass
