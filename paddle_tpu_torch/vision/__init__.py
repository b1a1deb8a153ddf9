"""vision (``paddle_tpu.vision``): ``models`` (LeNet, ResNet, VGG,
MobileNet), ``datasets`` and ``transforms``.  ``ops`` is still to port."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import transforms  # noqa: F401
