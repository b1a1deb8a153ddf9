"""Activations (the activation part of ``paddle_tpu.nn.functional``),
each one paddle op through ``core.dispatch.apply`` with the JAX
package's formula.  ``relu`` and ``gelu`` live in the package
``__init__``.  The in-place forms (``elu_``, ``relu_``, ``softmax_``,
``tanh_``) write into ``x`` with torch's in-place ops, so autograd
sees them as it sees any in-place op.  ``gumbel_softmax`` draws its
noise from the device's ``core.rng`` generator."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core import rng
from ...core.dispatch import apply

__all__ = ["relu6", "sigmoid", "tanh", "silu", "swish", "mish", "softsign",
           "tanhshrink", "hardswish", "leaky_relu", "prelu", "elu", "selu",
           "celu", "hardsigmoid", "hardtanh", "hardshrink", "softshrink",
           "softplus", "maxout", "softmax", "log_softmax", "log_sigmoid",
           "thresholded_relu", "glu", "normalize", "elu_", "relu_",
           "softmax_", "tanh_", "gumbel_softmax"]


def _act(tfn, op_name):
    def op(x, name=None):
        return apply(tfn, x, op_name=op_name)
    op.__name__ = op_name
    return op


def _tanhshrink(a):
    return a - torch.tanh(a)


relu6 = _act(TF.relu6, "relu6")
sigmoid = _act(torch.sigmoid, "sigmoid")
tanh = _act(torch.tanh, "tanh")
silu = _act(TF.silu, "silu")
swish = silu
mish = _act(TF.mish, "mish")
softsign = _act(TF.softsign, "softsign")
tanhshrink = _act(_tanhshrink, "tanhshrink")
hardswish = _act(TF.hardswish, "hardswish")
log_sigmoid = _act(TF.logsigmoid, "log_sigmoid")


def _leaky_relu(a, *, negative_slope):
    return TF.leaky_relu(a, negative_slope)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply(_leaky_relu, x, op_name="leaky_relu",
                 attrs={"negative_slope": float(negative_slope)})


def _prelu(a, w, *, data_format):
    if w.numel() == 1:
        return torch.where(a >= 0, a, w.reshape(()) * a)
    shape = [1] * a.dim()
    shape[1 if data_format.startswith("NC") else a.dim() - 1] = w.numel()
    return torch.where(a >= 0, a, w.reshape(shape) * a)


def prelu(x, weight, data_format="NCHW", name=None):
    return apply(_prelu, x, weight, op_name="prelu",
                 attrs={"data_format": data_format})


def _elu(a, *, alpha):
    return TF.elu(a, alpha)


def elu(x, alpha=1.0, name=None):
    return apply(_elu, x, op_name="elu", attrs={"alpha": float(alpha)})


def _selu(a, *, scale, alpha):
    return scale * torch.where(a > 0, a, alpha * torch.expm1(a))


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    return apply(_selu, x, op_name="selu",
                 attrs={"scale": scale, "alpha": alpha})


def _celu(a, *, alpha):
    return TF.celu(a, alpha)


def celu(x, alpha=1.0, name=None):
    return apply(_celu, x, op_name="celu", attrs={"alpha": float(alpha)})


def _hardsigmoid(a, *, slope, offset):
    return torch.clamp(a * slope + offset, 0.0, 1.0)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply(_hardsigmoid, x, op_name="hardsigmoid",
                 attrs={"slope": slope, "offset": offset})


def _hardtanh(a, *, lo, hi):
    return torch.clamp(a, lo, hi)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply(_hardtanh, x, op_name="hardtanh",
                 attrs={"lo": min, "hi": max})


def _hardshrink(a, *, threshold):
    return torch.where(torch.abs(a) > threshold, a, torch.zeros_like(a))


def hardshrink(x, threshold=0.5, name=None):
    return apply(_hardshrink, x, op_name="hardshrink",
                 attrs={"threshold": threshold})


def _softshrink(a, *, threshold):
    zero = torch.zeros_like(a)
    return torch.where(a > threshold, a - threshold,
                       torch.where(a < -threshold, a + threshold, zero))


def softshrink(x, threshold=0.5, name=None):
    return apply(_softshrink, x, op_name="softshrink",
                 attrs={"threshold": threshold})


def _softplus(a, *, beta, threshold):
    return torch.where(a * beta > threshold, a,
                       torch.log1p(torch.exp(beta * a)) / beta)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply(_softplus, x, op_name="softplus",
                 attrs={"beta": beta, "threshold": threshold})


def _maxout(a, *, groups, axis):
    ax = axis % a.dim()
    c = a.shape[ax]
    shape = list(a.shape[:ax]) + [c // groups, groups] + list(
        a.shape[ax + 1:])
    return torch.amax(torch.reshape(a, shape), ax + 1)


def maxout(x, groups, axis=1, name=None):
    return apply(_maxout, x, op_name="maxout",
                 attrs={"groups": int(groups), "axis": int(axis)})


def _softmax(a, *, axis):
    return torch.softmax(a, axis)


def _log_softmax(a, *, axis):
    return torch.log_softmax(a, axis)


def softmax(x, axis=-1, dtype=None, name=None):
    return apply(_softmax, x, op_name="softmax", attrs={"axis": int(axis)})


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply(_log_softmax, x, op_name="log_softmax",
                 attrs={"axis": int(axis)})


def _thresholded_relu(a, *, threshold):
    return torch.where(a > threshold, a, torch.zeros_like(a))


def thresholded_relu(x, threshold=1.0, name=None):
    return apply(_thresholded_relu, x, op_name="thresholded_relu",
                 attrs={"threshold": float(threshold)})


def _glu(a, *, axis):
    return TF.glu(a, axis)


def glu(x, axis=-1, name=None):
    return apply(_glu, x, op_name="glu", attrs={"axis": int(axis)})


def _normalize(a, *, p, axis, epsilon):
    nrm = torch.sum(torch.abs(a) ** p, axis, keepdim=True) ** (1.0 / p)
    return a / torch.clamp_min(nrm, epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return apply(_normalize, x, op_name="normalize",
                 attrs={"p": p, "axis": int(axis), "epsilon": epsilon})


def elu_(x, alpha=1.0, name=None):
    """In-place ``elu``."""
    TF.elu_(x, alpha)
    return x


def relu_(x, name=None):
    """In-place ``relu``."""
    torch.Tensor.relu_(x)
    return x


def softmax_(x, axis=-1, dtype=None, name=None):
    """In-place ``softmax``."""
    torch.Tensor.copy_(x, torch.softmax(x, int(axis)))
    return x


def tanh_(x, name=None):
    """In-place ``tanh``."""
    torch.Tensor.tanh_(x)
    return x


def _gumbel_softmax(a, *, temperature, hard, axis):
    # -log(E), E ~ Exp(1), is Gumbel(0, 1)
    e = torch.empty_like(a).exponential_(generator=rng.generator(a.device))
    y = torch.softmax((a - torch.log(e)) / temperature, axis)
    if hard:
        one = torch.zeros_like(y).scatter_(
            axis, torch.argmax(y, dim=axis, keepdim=True), 1.0)
        y = (one - y).detach() + y           # straight-through
    return y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with g ~ Gumbel(0, 1); ``hard``
    gives the one-hot of its argmax with the soft gradient."""
    return apply(_gumbel_softmax, x, op_name="gumbel_softmax",
                 attrs={"temperature": float(temperature),
                        "hard": bool(hard), "axis": int(axis)})
