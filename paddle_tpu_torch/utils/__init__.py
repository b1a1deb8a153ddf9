from . import checkpoint, crypto, fs, monitor, native_build  # noqa: F401
from .checkpoint import train_epoch_range  # noqa: F401
