"""The model zoo (``paddle_tpu.vision.models``): LeNet, ResNet, VGG and
MobileNet V1/V2, with paddle_tpu's layer and parameter names, so a
paddle_tpu model's ``state_dict`` (batch norm's ``_mean`` and
``_variance`` too) loads into the port's by name."""
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,  # noqa
                        mobilenet_v2)
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,  # noqa
                     resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
