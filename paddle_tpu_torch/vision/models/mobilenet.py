"""MobileNet V1/V2 (``paddle_tpu.vision.models.mobilenet``; reference:
python/paddle/vision/models/mobilenetv1.py, mobilenetv2.py)."""
from ... import nn


class _ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, relu6=True):
        pad = (kernel - 1) // 2
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=pad,
                      groups=groups, bias_attr=False),
            nn.BatchNorm2D(out_c),
            nn.ReLU6() if relu6 else nn.ReLU())


class _DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.dw = _ConvBNReLU(in_c, in_c, 3, stride, groups=in_c,
                              relu6=False)
        self.pw = _ConvBNReLU(in_c, out_c, 1, 1, relu6=False)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: max(int(c * scale), 8)
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_ConvBNReLU(3, s(32), 3, 2, relu6=False)]
        for in_c, out_c, stride in cfg:
            layers.append(_DepthwiseSeparable(s(in_c), s(out_c), stride))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU(inp, hidden, 1))
        layers.extend([
            _ConvBNReLU(hidden, hidden, 3, stride, groups=hidden),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup)])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_c = int(32 * scale)
        last_c = int(1280 * max(1.0, scale))
        features = [_ConvBNReLU(3, input_c, 3, 2)]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(_InvertedResidual(
                    input_c, out_c, s if i == 0 else 1, t))
                input_c = out_c
        features.append(_ConvBNReLU(input_c, last_c, 1))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
