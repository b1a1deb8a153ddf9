"""nn: the eager :class:`Layer` (a ``torch.nn.Module`` with paddle's
methods) and the layers and functions of ``paddle_tpu.nn`` ported so
far, with paddle_tpu's parameter names and layouts (``Linear.weight``
is ``[in, out]``), so a paddle_tpu state dict maps onto the port's
one-to-one (:func:`paddle_tpu_torch.framework_io.
state_dict_from_paddle_tpu`).  Parameters are paddle ``Parameter``s
made through :class:`ParamAttr` and :mod:`.initializer`
(``weight_attr`` / ``bias_attr``)."""
from . import functional, initializer, layer  # noqa: F401
from .layer import activation as _activation
from .layer import conv as _conv
from .layer import loss as _loss
from .layer import norm as _norm
from .layer import pooling as _pooling
from .layer import rnn as _rnn
from .layer import *  # noqa: F401,F403
from .layer_base import Layer, ParamAttr  # noqa: F401
from ..optimizer.clip import (ClipGradByGlobalNorm,  # noqa: F401
                              ClipGradByNorm, ClipGradByValue)

__all__ = (["functional", "initializer", "Layer", "ParamAttr", "Dropout",
            "Embedding", "LayerList", "LayerDict", "ParameterList",
            "Sequential", "Linear", "MultiHeadAttention",
            "TransformerEncoder", "TransformerEncoderLayer",
            "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
           + _activation.__all__ + _conv.__all__ + _loss.__all__
           + _norm.__all__ + _pooling.__all__ + _rnn.__all__)
