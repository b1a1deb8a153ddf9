from . import monitor  # noqa: F401
from .checkpoint import train_epoch_range  # noqa: F401
