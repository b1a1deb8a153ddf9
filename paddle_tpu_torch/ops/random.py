"""Random ops (``paddle_tpu.ops.random``).

Each draw comes from ``core.rng.generator(device)``, the generator of
the device the result lives on (the device ``set_device`` chose, else
the current CUDA device; a ``*_like``/in-place op follows its tensor).
``paddle.seed`` reseeds them, so the same seed gives the same stream;
the streams differ from the JAX package's threefry keys by design.
Integer results are int64."""
from __future__ import annotations

import torch

from ..core import rng
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.placement import device as _resolve_device
from ..core.tensor import wrap
from .creation import _scalar, _shape

__all__ = ["rand", "randn", "uniform", "normal", "standard_normal",
           "randint", "randint_like", "randperm", "shuffle", "bernoulli",
           "poisson", "multinomial", "exponential_", "normal_", "uniform_"]


def _dt(dtype):
    return get_default_dtype() if dtype is None else convert_dtype(dtype)


def _where(device=None):
    dev = _resolve_device(device)
    return dev, rng.generator(dev)


def rand(shape, dtype=None, name=None, device=None):
    dev, gen = _where(device)
    return wrap(torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                           generator=gen))


def randn(shape, dtype=None, name=None, device=None):
    dev, gen = _where(device)
    return wrap(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                            generator=gen))


def standard_normal(shape, dtype=None, name=None, device=None):
    return randn(shape, dtype, device=device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            device=None):
    """U[min, max); a nonzero ``seed`` draws from a generator of its
    own."""
    dev, gen = _where(device)
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    lo, hi = float(_scalar(min)), float(_scalar(max))
    u = torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                   generator=gen)
    return wrap(u * (hi - lo) + lo)


def normal(mean=0.0, std=1.0, shape=None, name=None, device=None):
    """N(mean, std) of ``shape`` (default: the shape of a tensor
    ``mean``)."""
    if shape is None:
        shape = tuple(mean.shape) if isinstance(mean, torch.Tensor) else ()
    dev = (mean.device if isinstance(mean, torch.Tensor)
           else _resolve_device(device))
    z = torch.randn(_shape(shape), dtype=get_default_dtype(), device=dev,
                    generator=rng.generator(dev))
    return wrap(z * std + mean)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None,
            device=None):
    if high is None:
        low, high = 0, low
    dev, gen = _where(device)
    return wrap(torch.randint(int(low), int(high), _shape(shape),
                              dtype=convert_dtype(dtype or "int64"),
                              device=dev, generator=gen))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, tuple(x.shape), dtype or "int64",
                   device=x.device)


def randperm(n, dtype="int64", name=None, device=None):
    dev, gen = _where(device)
    return wrap(torch.randperm(int(n), dtype=convert_dtype(dtype),
                               device=dev, generator=gen))


def shuffle(x, axis=0, name=None):
    """``x`` with its slices along ``axis`` in a random order."""
    perm = torch.randperm(x.shape[axis], device=x.device,
                          generator=rng.generator(x.device))
    return wrap(torch.index_select(x, axis, perm))


def bernoulli(x, name=None):
    return wrap(torch.bernoulli(x.detach(), generator=rng.generator(
        x.device)))


def poisson(x, name=None):
    return wrap(torch.poisson(x.detach(), generator=rng.generator(
        x.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """``num_samples`` class indices a row, drawn with probability
    proportional to ``x``'s row."""
    return wrap(torch.multinomial(x.detach().float(), int(num_samples),
                                  replacement=replacement,
                                  generator=rng.generator(x.device)))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        torch.Tensor.exponential_(x, lam, generator=rng.generator(x.device))
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        torch.Tensor.normal_(x, mean, std, generator=rng.generator(x.device))
    return x


def uniform_(x, min=-1.0, max=1.0, name=None):
    with torch.no_grad():
        torch.Tensor.uniform_(x, min, max, generator=rng.generator(x.device))
    return x
