from . import fault, models  # noqa: F401
