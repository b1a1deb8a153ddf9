"""Optimizer extras (paddle_tpu.optimizer.extras): the exponential
moving average of the parameters, ModelAverage and Lookahead.

The shadows are device tensors beside the parameters, updated by
multi-tensor ``_foreach`` ops: no host copy is made per step.
``apply`` swaps them into the parameters in place (``copy_``, so a
``jit.TrainStep`` holding the parameters sees them) and, as a context
manager, puts the trained values back on exit.
"""
from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["ExponentialMovingAverage", "ModelAverage",
           "LookaheadOptimizer", "Lookahead"]


def _data(params):
    return [p.detach() for p in params]


class _Applied:
    """``with owner.apply(): ...`` restores on exit when asked to."""

    def __init__(self, owner, restore: bool):
        self._owner, self._restore = owner, restore

    def __enter__(self):
        return self._owner

    def __exit__(self, *exc):
        if self._restore:
            self._owner.restore()
        return False


class _Swaps:
    """``apply``'s backup of the parameters and ``restore``."""

    _params: List[torch.Tensor]

    @torch.no_grad()
    def _swap_in(self, values, need_restore):
        data = _data(self._params)
        self._backup = [p.clone() for p in data]
        torch._foreach_copy_(data, [v.to(p.dtype) for v, p in zip(values,
                                                                 data)])
        return _Applied(self, need_restore)

    @torch.no_grad()
    def restore(self, executor=None):
        torch._foreach_copy_(_data(self._params), self._backup)


class ExponentialMovingAverage(_Swaps):
    """``shadow = decay * shadow + (1 - decay) * param`` after each
    :meth:`update`; with ``thres_steps`` the decay ramps as ``min(decay,
    (1 + t) / (10 + t))``.

        ema = ExponentialMovingAverage(0.999, parameters=model.parameters())
        for batch in data:
            train_step(...)
            ema.update()
        with ema.apply():          # evaluate with the averaged weights
            evaluate(model)
    """

    def __init__(self, decay: float = 0.999, thres_steps=None,
                 parameters: Optional[List[torch.Tensor]] = None,
                 name=None):
        self._decay = float(decay)
        self._thres = bool(thres_steps)
        self._params = list(parameters or [])
        self._shadow = [p.clone() for p in _data(self._params)]
        self._step = 0

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay
        if self._thres:
            d = min(d, (1.0 + self._step) / (10.0 + self._step))
        torch._foreach_mul_(self._shadow, d)
        torch._foreach_add_(self._shadow, torch._foreach_mul(
            [p.to(s.dtype) for p, s in zip(_data(self._params),
                                           self._shadow)], 1.0 - d))

    def apply(self, executor=None, need_restore: bool = True):
        """The shadows into the parameters (a context manager)."""
        return self._swap_in(self._shadow, need_restore)

    def state_dict(self):
        return {"step": self._step, "shadow": list(self._shadow)}

    def set_state_dict(self, sd):
        self._step = sd["step"]
        self._shadow = [torch.as_tensor(s).to(p.device).clone()
                        for p, s in zip(self._params, sd["shadow"])]


class ModelAverage(_Swaps):
    """The average of the parameters over a trailing window, in f32,
    with the reference's two blocks: the current one sums up to
    ``max_average_window`` steps, then becomes the previous one, so the
    window stays between ``max_w`` and ``2 * max_w`` steps."""

    def __init__(self, average_window_rate: float = 0.15,
                 parameters: Optional[List[torch.Tensor]] = None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None):
        self._params = list(parameters or [])
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._sum = self._zeros()
        self._prev = self._zeros()
        self._count = 0
        self._prev_count = 0

    def _zeros(self):
        return [torch.zeros_like(p, dtype=torch.float32)
                for p in _data(self._params)]

    @torch.no_grad()
    def step(self):
        if self._count >= self._max_w:
            self._prev, self._prev_count = self._sum, self._count
            self._sum, self._count = self._zeros(), 0
        self._count += 1
        torch._foreach_add_(self._sum, [p.float()
                                        for p in _data(self._params)])

    minimize = step

    def apply(self, executor=None, need_restore: bool = True):
        total = self._count + self._prev_count
        if total <= 0:
            raise RuntimeError("ModelAverage.apply before any step()")
        avg = torch._foreach_div(torch._foreach_add(self._sum, self._prev),
                                 float(total))
        return self._swap_in(avg, need_restore)


class LookaheadOptimizer:
    """Lookahead (Zhang et al. 2019): the inner (fast) optimizer runs
    ``k`` steps, then the slow weights move ``alpha`` of the way to the
    fast ones and the fast weights take the slow ones' values."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        if not (0.0 < alpha <= 1.0 and k >= 1):
            raise ValueError(f"Lookahead: alpha={alpha} must be in (0, 1] "
                             f"and k={k} at least 1")
        self.inner_optimizer = inner_optimizer
        self._alpha = float(alpha)
        self._k = int(k)
        self._params = list(inner_optimizer._parameter_list or [])
        self._slow = [p.clone() for p in _data(self._params)]
        self._i = 0

    def step(self):
        self.inner_optimizer.step()
        self._i += 1
        if self._i % self._k == 0:
            with torch.no_grad():
                fast = _data(self._params)
                diff = torch._foreach_sub([p.to(s.dtype) for p, s in zip(
                    fast, self._slow)], self._slow)
                torch._foreach_add_(self._slow, torch._foreach_mul(
                    diff, self._alpha))
                torch._foreach_copy_(fast, [s.to(p.dtype) for s, p in zip(
                    self._slow, fast)])

    def clear_grad(self, *a, **k):
        return self.inner_optimizer.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return None, None

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)


Lookahead = LookaheadOptimizer
