"""vision (``paddle_tpu.vision``): so far only ``models`` (LeNet, ResNet,
VGG, MobileNet).  Datasets, transforms and ops are still to port."""
from . import models  # noqa: F401
