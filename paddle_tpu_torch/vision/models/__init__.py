"""The model zoo (``paddle_tpu.vision.models``): LeNet so far."""
from .lenet import LeNet  # noqa: F401
