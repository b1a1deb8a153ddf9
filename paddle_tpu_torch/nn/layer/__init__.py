from . import activation, container, conv, loss, norm, pooling, rnn  # noqa
from . import common, transformer  # noqa: F401
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import (LayerDict, LayerList,  # noqa: F401
                        ParameterList, Sequential)
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
