"""nn: the layers and functions of ``paddle_tpu.nn`` that the BERT
training path runs, as ``torch.nn.Module``s with paddle_tpu's parameter
names and layouts (``Linear.weight`` is ``[in, out]``), so a paddle_tpu
state dict maps onto the port's one-to-one
(:func:`paddle_tpu_torch.framework_io.state_dict_from_paddle_tpu`)."""
from . import functional  # noqa: F401
from .layer import (Dropout, Embedding, LayerList, LayerNorm,  # noqa: F401
                    Linear, MultiHeadAttention, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["functional", "Dropout", "Embedding", "LayerList", "LayerNorm",
           "Linear", "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
