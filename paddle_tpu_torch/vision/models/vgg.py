"""VGG (``paddle_tpu.vision.models.vgg``; reference:
python/paddle/vision/models/vgg.py): vgg11-19, with batch norm after
each convolution when ``batch_norm``."""
from ... import nn

_cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_features(_cfgs["A"], batch_norm), **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_features(_cfgs["B"], batch_norm), **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_features(_cfgs["D"], batch_norm), **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_make_features(_cfgs["E"], batch_norm), **kwargs)
