"""vision (``paddle_tpu.vision``): so far only ``models.LeNet``, the
model of bench's ``bench_lenet_dygraph``.  Datasets, transforms, ops
and the other models are still to port."""
from . import models  # noqa: F401
