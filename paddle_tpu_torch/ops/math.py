"""Elementwise and matmul-family math (``paddle_tpu.ops.math``).

Each public op runs its torch function through :func:`core.dispatch.
apply` under the JAX package's op name, so it records on static
Variables, casts under ``auto_cast`` and returns a paddle Tensor.  A
Python number on either side of a binary op takes part as a scalar, as
in jnp's weak types."""
from __future__ import annotations

import torch

from ..core.dispatch import apply
from ..core.dtype import convert_dtype
from ..core.tensor import wrap

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "maximum", "minimum", "fmax", "fmin", "atan2",
    "hypot", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "square", "abs", "sign", "neg", "floor", "ceil", "round",
    "trunc", "frac", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfinv", "sigmoid",
    "reciprocal", "digamma", "lgamma", "isnan", "isinf", "isfinite", "conj",
    "real", "imag", "angle", "pow", "scale", "increment", "clip", "lerp",
    "stanh", "rad2deg", "deg2rad", "multiplex", "matmul", "mm", "bmm",
    "dot", "inner", "outer", "addmm", "kron", "cross", "einsum", "cumsum",
    "cumprod", "cummax", "logcumsumexp", "logaddexp", "trace", "nan_to_num",
    "add_n", "mv", "tanh_", "broadcast_shape", "rank", "shape"]


def _tensor_pair(a, b):
    """A Python number beside a tensor becomes a 0-d tensor on its
    device (a scalar in torch's type promotion)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, device=b.device)
    return a, b


def _binop(tfn, op_name):
    def impl(a, b):
        return tfn(*_tensor_pair(a, b))

    def op(x, y, name=None):
        return apply(impl, x, y, op_name=op_name)
    op.__name__ = op_name
    return op


def _unop(tfn, op_name):
    def op(x, name=None):
        return apply(tfn, x, op_name=op_name)
    op.__name__ = op_name
    return op


add = _binop(torch.add, "add")
subtract = _binop(torch.sub, "subtract")
multiply = _binop(torch.mul, "multiply")
divide = _binop(torch.true_divide, "divide")
floor_divide = _binop(torch.floor_divide, "floor_divide")
remainder = _binop(torch.remainder, "remainder")
mod = remainder
floor_mod = remainder
maximum = _binop(torch.maximum, "maximum")
minimum = _binop(torch.minimum, "minimum")
fmax = _binop(torch.fmax, "fmax")
fmin = _binop(torch.fmin, "fmin")
atan2 = _binop(torch.atan2, "atan2")
hypot = _binop(torch.hypot, "hypot")
logaddexp = _binop(torch.logaddexp, "logaddexp")


def _frac(a):
    return a - torch.trunc(a)


exp = _unop(torch.exp, "exp")
expm1 = _unop(torch.expm1, "expm1")
log = _unop(torch.log, "log")
log2 = _unop(torch.log2, "log2")
log10 = _unop(torch.log10, "log10")
log1p = _unop(torch.log1p, "log1p")
sqrt = _unop(torch.sqrt, "sqrt")
rsqrt = _unop(torch.rsqrt, "rsqrt")
square = _unop(torch.square, "square")
abs = _unop(torch.abs, "abs")
sign = _unop(torch.sign, "sign")
neg = _unop(torch.neg, "neg")
floor = _unop(torch.floor, "floor")
ceil = _unop(torch.ceil, "ceil")
round = _unop(torch.round, "round")
trunc = _unop(torch.trunc, "trunc")
frac = _unop(_frac, "frac")
sin = _unop(torch.sin, "sin")
cos = _unop(torch.cos, "cos")
tan = _unop(torch.tan, "tan")
asin = _unop(torch.asin, "asin")
acos = _unop(torch.acos, "acos")
atan = _unop(torch.atan, "atan")
sinh = _unop(torch.sinh, "sinh")
cosh = _unop(torch.cosh, "cosh")
tanh = _unop(torch.tanh, "tanh")
asinh = _unop(torch.asinh, "asinh")
acosh = _unop(torch.acosh, "acosh")
atanh = _unop(torch.atanh, "atanh")
erf = _unop(torch.erf, "erf")
erfinv = _unop(torch.erfinv, "erfinv")
sigmoid = _unop(torch.sigmoid, "sigmoid")
reciprocal = _unop(torch.reciprocal, "reciprocal")
digamma = _unop(torch.digamma, "digamma")
lgamma = _unop(torch.lgamma, "lgamma")
isnan = _unop(torch.isnan, "isnan")
isinf = _unop(torch.isinf, "isinf")
isfinite = _unop(torch.isfinite, "isfinite")
conj = _unop(torch.conj, "conj")
real = _unop(torch.real, "real")
imag = _unop(torch.imag, "imag")
angle = _unop(torch.angle, "angle")


def pow(x, y, name=None):
    return apply(torch.pow, x, y, op_name="pow")


def _scale(a, s, b, *, bias_after_scale):
    return a * s + b if bias_after_scale else (a + b) * s


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """reference: operators/scale_op.cc semantics."""
    out = apply(_scale, x, scale, bias, op_name="scale",
                attrs={"bias_after_scale": bool(bias_after_scale)})
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def increment(x, value=1.0, name=None):
    """``x += value`` in place (a counter: no gradient)."""
    with torch.no_grad():
        torch.Tensor.add_(x, value)
    return x


def _clip(a, lo, hi):
    return torch.clamp(a, lo, hi)


def clip(x, min=None, max=None, name=None):
    return apply(_clip, x, min, max, op_name="clip")


def _lerp(a, b, w):
    return a + w * (b - a)


def lerp(x, y, weight, name=None):
    return apply(_lerp, x, y, weight, op_name="lerp")


def _stanh(a, *, scale_a, scale_b):
    return scale_b * torch.tanh(scale_a * a)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply(_stanh, x, op_name="stanh",
                 attrs={"scale_a": scale_a, "scale_b": scale_b})


rad2deg = _unop(torch.rad2deg, "rad2deg")
deg2rad = _unop(torch.deg2rad, "deg2rad")


def _multiplex(idx, *xs):
    stacked = torch.stack(xs, 0)
    sel = idx.reshape(1, -1, *([1] * (stacked.dim() - 2))).long()
    sel = sel.expand(1, *stacked.shape[1:])
    return torch.gather(stacked, 0, sel)[0]


def multiplex(inputs, index, name=None):
    return apply(_multiplex, index, *inputs, op_name="multiplex")


# -- matmul family ----------------------------------------------------------

def _matmul(a, b, *, transpose_x=False, transpose_y=False):
    if transpose_x and a.dim() >= 2:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() >= 2:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    attrs = ({"transpose_x": bool(transpose_x),
              "transpose_y": bool(transpose_y)}
             if transpose_x or transpose_y else None)
    return apply(_matmul, x, y, op_name="matmul", attrs=attrs)


mm = matmul


def bmm(x, y, name=None):
    return apply(torch.matmul, x, y, op_name="bmm")


def _dot(a, b):
    return (a * b).sum(-1)


def dot(x, y, name=None):
    return apply(_dot, x, y, op_name="dot")


def inner(x, y, name=None):
    return apply(torch.inner, x, y, op_name="inner")


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


def outer(x, y, name=None):
    return apply(_outer, x, y, op_name="outer")


def _addmm(i, a, b, *, beta, alpha):
    return beta * i + alpha * torch.matmul(a, b)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply(_addmm, input, x, y, op_name="addmm",
                 attrs={"beta": beta, "alpha": alpha})


def kron(x, y, name=None):
    return apply(torch.kron, x, y, op_name="kron")


def _cross(a, b, *, axis):
    if axis == 9:
        axis = next(i for i, d in enumerate(a.shape) if d == 3)
    return torch.linalg.cross(a, b, dim=axis)


def cross(x, y, axis=9, name=None):
    return apply(_cross, x, y, op_name="cross", attrs={"axis": axis})


def _einsum(*xs, equation):
    return torch.einsum(equation, *xs)


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply(_einsum, *operands, op_name="einsum",
                 attrs={"equation": equation})


# -- cumulative ---------------------------------------------------------------

def _dt(dtype):
    return None if dtype is None else convert_dtype(dtype)


def _cumsum(a, *, axis, dtype):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.cumsum(a, axis, dtype=_dt(dtype))


def cumsum(x, axis=None, dtype=None, name=None):
    return apply(_cumsum, x, op_name="cumsum",
                 attrs={"axis": axis, "dtype": dtype})


def _cumprod(a, *, dim, dtype):
    if dim is None:
        a, dim = a.reshape(-1), 0
    return torch.cumprod(a, dim, dtype=_dt(dtype))


def cumprod(x, dim=None, dtype=None, name=None):
    return apply(_cumprod, x, op_name="cumprod",
                 attrs={"dim": dim, "dtype": dtype})


def _cummax(a, *, axis):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.cummax(a, axis).values


def cummax(x, axis=None, dtype="int64", name=None):
    """The running maximum (values, as paddle_tpu returns them)."""
    return apply(_cummax, x, op_name="cummax", attrs={"axis": axis})


def _logcumsumexp(a, *, axis):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.logcumsumexp(a, axis)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    return apply(_logcumsumexp, x, op_name="logcumsumexp",
                 attrs={"axis": axis})


def _trace(a, *, offset, axis1, axis2):
    return torch.diagonal(a, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(_trace, x, op_name="trace",
                 attrs={"offset": offset, "axis1": axis1, "axis2": axis2})


def _nan_to_num(a, *, nan, posinf, neginf):
    return torch.nan_to_num(a, nan, posinf, neginf)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply(_nan_to_num, x, op_name="nan_to_num",
                 attrs={"nan": nan, "posinf": posinf, "neginf": neginf})


def _add_n(*xs):
    out = xs[0]
    for a in xs[1:]:
        out = out + a
    return out


def add_n(inputs, name=None):
    """reference: operators/sum_op.cc — elementwise sum of a list."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    return apply(_add_n, *inputs, op_name="add_n")


def mv(x, vec, name=None):
    return apply(torch.mv, x, vec, op_name="mv")


def tanh_(x, name=None):
    """In-place tanh."""
    torch.Tensor.tanh_(x)
    return x


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def rank(input, name=None):
    """The rank as a 0-d int32 tensor."""
    return wrap(torch.tensor(input.dim(), dtype=torch.int32,
                             device=input.device))


def shape(input, name=None):
    """The runtime shape as a 1-d int32 tensor."""
    return wrap(torch.tensor(list(input.shape), dtype=torch.int32,
                             device=input.device))

