from . import flags, obs_hook, profiler_hook, rng  # noqa: F401
from .placement import device  # noqa: F401
