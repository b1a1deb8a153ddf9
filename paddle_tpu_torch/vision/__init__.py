"""vision (``paddle_tpu.vision``): ``models`` (LeNet, ResNet, VGG,
MobileNet), ``datasets``, ``transforms`` and ``ops`` (detection
primitives)."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
