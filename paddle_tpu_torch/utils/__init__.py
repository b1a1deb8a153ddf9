"""paddle_tpu_torch.utils (the counterpart of ``paddle_tpu.utils``):

- :mod:`custom_op` — a user's op on torch tensors registered through
  the op dispatch point (tape, AMP cast, profiler, static capture),
  with an optional backward pair;
- :mod:`cpp_extension` — C++ host kernels compiled at run time against
  torch's operator registration;
- :mod:`op_version` — per-op version numbers and notes;
- :mod:`checkpoint`, :mod:`crypto`, :mod:`fs`, :mod:`monitor`,
  :mod:`native_build` — snapshots and epoch ranges, encryption, file
  systems, stat gauges, the shared native build step.
"""
from . import (checkpoint, cpp_extension, crypto, custom_op,  # noqa: F401
               fs, monitor, native_build, op_version)
from .checkpoint import train_epoch_range  # noqa: F401
from .custom_op import register_custom_op  # noqa: F401
