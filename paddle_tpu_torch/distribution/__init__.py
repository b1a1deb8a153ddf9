"""Probability distributions (the counterpart of
``paddle_tpu/distribution``; reference: python/paddle/distribution.py —
Distribution, Uniform, Normal, Categorical, Bernoulli).

The parameters are tensors on the default device (``set_device``'s
choice, else the current CUDA device) unless a Tensor is passed, which
keeps its own.  Densities, entropies and divergences are paddle_tpu's
formulas in float32 and carry gradients to the value.  Samples draw from
the device generator of :mod:`..core.rng` (Philox), not from
paddle_tpu's threefry keys: the same seed gives other samples of the same
law.  Categorical samples are int64 (paddle_tpu's int32)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng as _rng
from ..core.dispatch import apply  # noqa: F401  (paddle_tpu's names here)
from ..core.rng import next_key  # noqa: F401
from ..core.tensor import Tensor, wrap
from ..nn.functional import as_array  # noqa: F401

__all__ = ["Distribution", "Uniform", "Normal", "Categorical", "Bernoulli",
           "kl_divergence", "Tensor"]


def _param(x) -> torch.Tensor:
    """A parameter as a plain tensor: a Tensor as it is (on its device),
    anything else as float32 on the default device."""
    if isinstance(x, torch.Tensor):
        return torch.Tensor.as_subclass(torch.Tensor.detach(x),
                                        torch.Tensor)
    from ..core import placement
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=placement.device(None))


def _value(v, like: torch.Tensor) -> torch.Tensor:
    """The value as a plain tensor, still on the autograd graph."""
    if isinstance(v, torch.Tensor):
        return torch.Tensor.as_subclass(v, torch.Tensor)
    return torch.as_tensor(np.asarray(v), device=like.device)


def _draw(kind, shape, like: torch.Tensor) -> torch.Tensor:
    gen = _rng.generator(like.device)
    fn = torch.rand if kind == "uniform" else torch.randn
    return fn(tuple(shape), generator=gen, device=like.device,
              dtype=torch.float32)


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return wrap(torch.exp(self.log_prob(value)))

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _param(low)
        self.high = _param(high)

    def sample(self, shape=(), seed=0):
        shape = tuple(shape) + tuple(self.low.shape)
        u = _draw("uniform", shape, self.low)
        return wrap(self.low + u * (self.high - self.low))

    def log_prob(self, value):
        v = _value(value, self.low)
        inside = (v >= self.low) & (v < self.high)
        return wrap(torch.where(inside, -torch.log(self.high - self.low),
                                torch.full_like(v, -math.inf)))

    def entropy(self):
        return wrap(torch.log(self.high - self.low))


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)

    def sample(self, shape=(), seed=0):
        shape = tuple(shape) + tuple(self.loc.shape)
        z = _draw("normal", shape, self.loc)
        return wrap(self.loc + z * self.scale)

    def log_prob(self, value):
        v = _value(value, self.loc)
        return wrap(-((v - self.loc) ** 2) / (2 * self.scale ** 2)
                    - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return wrap(0.5 + 0.5 * math.log(2 * math.pi)
                    + torch.log(self.scale) + torch.zeros_like(self.loc))

    def kl_divergence(self, other):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return wrap(0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio)))


class Categorical(Distribution):
    """Over the last axis of ``logits``; ``log_prob``/``probs`` take one
    index per row of ``logits`` (``value`` has one axis fewer)."""

    def __init__(self, logits, name=None):
        self.logits = _param(logits)

    def sample(self, shape=()):
        batch = tuple(self.logits.shape[:-1])
        p = torch.softmax(self.logits, dim=-1)
        u = _draw("uniform", tuple(shape) + batch + (1,), self.logits)
        idx = (torch.cumsum(p, dim=-1) <= u).sum(-1)
        return wrap(idx.clamp_(max=p.shape[-1] - 1))

    def _probs(self):
        return torch.softmax(self.logits, dim=-1)

    def _pick(self, table, value):
        v = _value(value, self.logits).long()
        return wrap(torch.gather(table, -1, v[..., None])[..., 0])

    def log_prob(self, value):
        return self._pick(torch.log_softmax(self.logits, dim=-1), value)

    def probs(self, value):
        return self._pick(self._probs(), value)

    def entropy(self):
        p = self._probs()
        return wrap(-torch.sum(p * torch.log_softmax(self.logits, dim=-1),
                               dim=-1))

    def kl_divergence(self, other):
        p = self._probs()
        return wrap(torch.sum(p * (torch.log_softmax(self.logits, dim=-1)
                                   - torch.log_softmax(other.logits,
                                                       dim=-1)), dim=-1))


class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        self.p = _param(probs)

    def sample(self, shape=()):
        shape = tuple(shape) + tuple(self.p.shape)
        u = _draw("uniform", shape, self.p)
        return wrap((u < self.p).to(torch.float32))

    def log_prob(self, value):
        v = _value(value, self.p)
        p = self.p
        return wrap(v * torch.log(torch.clamp(p, min=1e-12))
                    + (1 - v) * torch.log(torch.clamp(1 - p, min=1e-12)))

    def entropy(self):
        p = self.p
        return wrap(-(p * torch.log(torch.clamp(p, min=1e-12))
                      + (1 - p) * torch.log(torch.clamp(1 - p,
                                                        min=1e-12))))


def kl_divergence(p: Distribution, q: Distribution):
    return p.kl_divergence(q)
