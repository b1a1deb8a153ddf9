"""nn: the eager :class:`Layer` (a ``torch.nn.Module`` with paddle's
methods) and the layers and functions of ``paddle_tpu.nn`` ported so
far, with paddle_tpu's parameter names and layouts (``Linear.weight``
is ``[in, out]``), so a paddle_tpu state dict maps onto the port's
one-to-one (:func:`paddle_tpu_torch.framework_io.
state_dict_from_paddle_tpu`).  Parameters are paddle ``Parameter``s
made through :class:`ParamAttr` and :mod:`.initializer`
(``weight_attr`` / ``bias_attr``)."""
from . import decode, functional, initializer, layer, utils  # noqa: F401
from .decode import (BeamSearchDecoder, cell_step,  # noqa: F401
                     dynamic_decode, gather_tree)
from .layer import activation as _activation
from .layer import common as _common
from .layer import conv as _conv
from .layer import loss as _loss
from .layer import norm as _norm
from .layer import pooling as _pooling
from .layer import rnn as _rnn
from .layer import transformer as _transformer
from .layer import *  # noqa: F401,F403
from .layer_base import Layer, ParamAttr  # noqa: F401
from .utils import remove_weight_norm, weight_norm  # noqa: F401
from ..optimizer.clip import (ClipGradByGlobalNorm,  # noqa: F401
                              ClipGradByNorm, ClipGradByValue)

__all__ = (["functional", "initializer", "Layer", "ParamAttr", "LayerList",
            "LayerDict", "ParameterList", "Sequential",
            "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
            "BeamSearchDecoder", "cell_step", "dynamic_decode",
            "gather_tree", "weight_norm", "remove_weight_norm"]
           + _activation.__all__ + _common.__all__ + _conv.__all__
           + _loss.__all__ + _norm.__all__ + _pooling.__all__
           + _rnn.__all__ + _transformer.__all__)
