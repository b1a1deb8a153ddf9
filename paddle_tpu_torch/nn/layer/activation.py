"""Activation layers (``paddle_tpu.nn.layer.activation``): each calls
its ``nn.functional`` function with the arguments it was built with."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish",
           "Softsign", "Tanhshrink", "Hardswish", "Hardsigmoid", "GLU",
           "LogSigmoid", "GELU", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU",
           "Hardtanh", "Hardshrink", "Softshrink", "Softplus", "Softmax",
           "LogSoftmax", "Maxout", "ThresholdedReLU"]


def _simple(fname, cls_name):
    class _Act(Layer):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return getattr(F, fname)(x)
    _Act.__name__ = cls_name
    _Act.__qualname__ = cls_name
    return _Act


ReLU = _simple("relu", "ReLU")
ReLU6 = _simple("relu6", "ReLU6")
Sigmoid = _simple("sigmoid", "Sigmoid")
Tanh = _simple("tanh", "Tanh")
Silu = _simple("silu", "Silu")
Swish = _simple("swish", "Swish")
Mish = _simple("mish", "Mish")
Softsign = _simple("softsign", "Softsign")
Tanhshrink = _simple("tanhshrink", "Tanhshrink")
Hardswish = _simple("hardswish", "Hardswish")
Hardsigmoid = _simple("hardsigmoid", "Hardsigmoid")
GLU = _simple("glu", "GLU")
LogSigmoid = _simple("log_sigmoid", "LogSigmoid")


def _with_args(fname, cls_name, **defaults):
    """A layer whose constructor takes ``defaults``' keywords, in order,
    and passes them on to ``F.<fname>``."""
    names = list(defaults)

    def __init__(self, *args, name=None, **kwargs):
        Layer.__init__(self)
        vals = dict(defaults)
        vals.update(zip(names, args))
        vals.update(kwargs)
        self._args = vals

    def forward(self, x):
        return getattr(F, fname)(x, **self._args)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._args.items())

    return type(cls_name, (Layer,), {"__init__": __init__,
                                     "forward": forward,
                                     "extra_repr": extra_repr})


GELU = _with_args("gelu", "GELU", approximate=False)
LeakyReLU = _with_args("leaky_relu", "LeakyReLU", negative_slope=0.01)
ELU = _with_args("elu", "ELU", alpha=1.0)
SELU = _with_args("selu", "SELU", scale=1.0507009873554804934193349852946,
                  alpha=1.6732632423543772848170429916717)
CELU = _with_args("celu", "CELU", alpha=1.0)
Hardtanh = _with_args("hardtanh", "Hardtanh", min=-1.0, max=1.0)
Hardshrink = _with_args("hardshrink", "Hardshrink", threshold=0.5)
Softshrink = _with_args("softshrink", "Softshrink", threshold=0.5)
Softplus = _with_args("softplus", "Softplus", beta=1.0, threshold=20.0)
Softmax = _with_args("softmax", "Softmax", axis=-1)
LogSoftmax = _with_args("log_softmax", "LogSoftmax", axis=-1)
Maxout = _with_args("maxout", "Maxout", groups=1, axis=1)
ThresholdedReLU = _with_args("thresholded_relu", "ThresholdedReLU",
                             threshold=1.0)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
