"""nn: the layers and functions of ``paddle_tpu.nn`` that the BERT
training path runs, as ``torch.nn.Module``s with paddle_tpu's parameter
names and layouts (``Linear.weight`` is ``[in, out]``), so a paddle_tpu
state dict maps onto the port's one-to-one
(:func:`paddle_tpu_torch.framework_io.state_dict_from_paddle_tpu`).
Parameters are made through :class:`ParamAttr` and :mod:`.initializer`
(``weight_attr`` / ``bias_attr``)."""
from . import functional, initializer  # noqa: F401
from .layer_base import ParamAttr  # noqa: F401
from .layer import (Dropout, Embedding, LayerList, LayerNorm,  # noqa: F401
                    Linear, MultiHeadAttention, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["functional", "initializer", "ParamAttr", "Dropout", "Embedding", "LayerList", "LayerNorm",
           "Linear", "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
