"""Pooling layers (``paddle_tpu.nn.layer.pooling``)."""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format=None, **extra):
        super().__init__()
        self.args = (kernel_size, stride, padding)
        self.ceil_mode = ceil_mode
        self.data_format = data_format
        self.extra = extra

    def forward(self, x):
        kw = dict(self.extra, ceil_mode=self.ceil_mode)
        if self.data_format is not None:
            kw["data_format"] = self.data_format
        return type(self)._fn(x, *self.args, **kw)

    def extra_repr(self):
        k, s, p = self.args
        return f"kernel_size={k}, stride={s}, padding={p}"


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, data_format)


class MaxPool3D(_Pool):
    _fn = staticmethod(F.max_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, data_format)


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         exclusive=exclusive)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, data_format,
                         exclusive=exclusive)


class AvgPool3D(_Pool):
    _fn = staticmethod(F.avg_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, data_format,
                         exclusive=exclusive)


class _Adaptive(Layer):
    _fn = None

    def __init__(self, output_size, data_format=None, return_mask=False):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format
        self.return_mask = return_mask

    def forward(self, x):
        if self.data_format is not None:
            return type(self)._fn(x, self.output_size, self.data_format)
        return type(self)._fn(x, self.output_size)

    def extra_repr(self):
        return f"output_size={self.output_size}"


class AdaptiveAvgPool1D(_Adaptive):
    _fn = staticmethod(F.adaptive_avg_pool1d)

    def __init__(self, output_size, name=None):
        super().__init__(output_size)


class AdaptiveAvgPool2D(_Adaptive):
    _fn = staticmethod(F.adaptive_avg_pool2d)

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveAvgPool3D(_Adaptive):
    _fn = staticmethod(F.adaptive_avg_pool3d)

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveMaxPool1D(_Adaptive):
    _fn = staticmethod(F.adaptive_max_pool1d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)


class AdaptiveMaxPool2D(_Adaptive):
    _fn = staticmethod(F.adaptive_max_pool2d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)


class AdaptiveMaxPool3D(_Adaptive):
    _fn = staticmethod(F.adaptive_max_pool3d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)
