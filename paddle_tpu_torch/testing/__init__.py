from . import chaos, fault, models  # noqa: F401
