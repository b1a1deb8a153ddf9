"""Weight initializers (``paddle_tpu.nn.initializer``).

Each initializer is called as ``init(shape, dtype, device)`` and returns
a new tensor on ``device`` (``None``: the device ``set_device`` chose,
else the current CUDA device), drawn from that device's generator
``core.rng.generator(device)``.  The draws differ from the JAX
package's threefry keys by design; the distributions, the fan rules and
the deterministic initializers are the same.
"""
from __future__ import annotations

import math

import torch

from ...core import rng
from ...core.dtype import convert_dtype
from ...core.placement import device as _resolve_device

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac", "constant",
           "normal", "uniform", "next_key"]

next_key = rng.next_key


def _fans(shape):
    """(fan_in, fan_out): a matrix is ``[in, out]``; a conv kernel is
    ``[out_c, in_c, *spatial]`` (paddle's layout)."""
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=torch.float32, device=None):
        raise NotImplementedError

    @staticmethod
    def _where(shape, dtype, device):
        dev = _resolve_device(device)
        return tuple(int(s) for s in shape), convert_dtype(dtype), dev, \
            rng.generator(dev)


def _normal(shape, dtype, device, std, mean=0.0):
    shape, dtype, dev, gen = Initializer._where(shape, dtype, device)
    out = torch.randn(shape, device=dev, generator=gen) * std
    if mean:
        out = out + mean
    return out.to(dtype)


def _uniform(shape, dtype, device, low, high):
    shape, dtype, dev, gen = Initializer._where(shape, dtype, device)
    out = torch.rand(shape, device=dev, generator=gen)
    return (out * (high - low) + low).to(dtype)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None):
        shape, dtype, dev, _ = self._where(shape, dtype, device)
        return torch.full(shape, self.value, dtype=dtype, device=dev)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None):
        return _normal(shape, dtype, device, self.std, self.mean)


class TruncatedNormal(Initializer):
    """N(mean, std) cut at two standard deviations, as the JAX package's
    ``truncated_normal(-2, 2)``: the unit draws are resampled, by the
    inverse of the normal CDF over the kept range."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None):
        shape, dtype, dev, gen = self._where(shape, dtype, device)
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                  for b in (-2.0, 2.0))
        u = torch.rand(shape, device=dev, generator=gen) * (hi - lo) + lo
        z = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp(-2.0, 2.0)
        return (z * self.std + self.mean).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device=None):
        return _uniform(shape, dtype, device, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        fi, fo = _fans(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        return _normal(shape, dtype, device,
                       self.gain * math.sqrt(2.0 / (fi + fo)))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        fi, fo = _fans(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, device, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype=torch.float32, device=None):
        fi = self.fan_in or _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return _normal(shape, dtype, device, gain / math.sqrt(fi))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype=torch.float32, device=None):
        fi = self.fan_in or _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, device, -limit, limit)


class Assign(Initializer):
    """The given values (an array, a list or a tensor) in ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None):
        shape, dtype, dev, _ = self._where(shape, dtype, device)
        out = torch.as_tensor(self.value).to(device=dev, dtype=dtype)
        if tuple(out.shape) != shape:
            raise ValueError(f"Assign initializer shape {tuple(out.shape)} "
                             f"!= param shape {shape}")
        return out


def _orthogonal(shape, dtype, device, gain):
    """``jax.nn.initializers.orthogonal(gain)`` (column axis -1): the Q of
    a normal matrix's QR with its columns' signs fixed by R's diagonal,
    transposed when there are fewer rows than columns."""
    shape, dtype, dev, gen = Initializer._where(shape, dtype, device)
    if len(shape) < 2:
        raise ValueError("orthogonal initializer needs at least 2 dims")
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    flat = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
    a = torch.randn(flat, device=dev, generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.t()
    return (gain * q.reshape(shape)).to(dtype)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        return _orthogonal(shape, dtype, device, self.gain)


class Dirac(Initializer):
    """The JAX package's ``Dirac``: ``jax.nn.initializers.
    delta_orthogonal()`` over a 3-5 dim kernel ``[*spatial, in, out]``:
    zero but at the spatial centre (index ``(k - 1) // 2`` on each
    spatial dim), which holds an orthogonal ``[in, out]`` matrix
    (``in <= out``)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32, device=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) not in (3, 4, 5):
            raise ValueError("Dirac needs a 3, 4 or 5 dim kernel")
        if shape[-2] > shape[-1]:
            raise ValueError("Dirac needs in channels <= out channels")
        centre = _orthogonal(shape[-2:], dtype, device, 1.0)
        out = torch.zeros(shape, dtype=centre.dtype, device=centre.device)
        out[tuple((k - 1) // 2 for k in shape[:-2])] = centre
        return out


# lowercase aliases used by ParamAttr(initializer=...)
constant = Constant
normal = Normal
uniform = Uniform
