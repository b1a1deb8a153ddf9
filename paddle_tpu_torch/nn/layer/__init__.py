from . import activation, container, conv, loss, pooling  # noqa: F401
from .activation import *  # noqa: F401,F403
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import (LayerDict, LayerList,  # noqa: F401
                        ParameterList, Sequential)
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import LayerNorm  # noqa: F401
from .pooling import *  # noqa: F401,F403
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
