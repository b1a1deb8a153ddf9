"""Optimizer base, Adam and AdamW (paddle_tpu.optimizer.optimizer).

Every optimizer defines two pure functions over tensors, as in
paddle_tpu: ``init_slots`` and the list-wise ``update``, shared by

- :meth:`Optimizer.functional_update` (pure: returns new parameter and
  slot tensors; ``jit.TrainStep`` writes them back in place), and
- the eager :meth:`Optimizer.step` (reads ``param.grad``).

The update runs as PyTorch's multi-tensor ``_foreach`` ops over all
parameters at once, in plain arithmetic.  The fused kernel (K3,
``ops.fused_adam``) takes over from it only in the static Executor, for
a plain f32 Adam, as in paddle_tpu.

``multi_precision``: a bf16/f16 parameter keeps an f32 master copy in
its slots; the update runs on the master, and the parameter is its
cast.  AdamW's decoupled decay acts on the master before the update.

``learning_rate`` is a float or an :class:`~.lr.LRScheduler`, read by
:meth:`Optimizer.get_lr`.  ``step``, the update's count for Adam's bias
corrections, is an int, or a 0-d device tensor where ``jit.TrainStep``
keeps the count on the card (loss scaling skips steps there without a
host read).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .clip import ClipGradBase
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW"]

_LOW = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                raise NotImplementedError("parameter groups are not ported")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError("regularizer objects are not ported; "
                                      "pass a float")
        if not isinstance(learning_rate, LRScheduler):
            learning_rate = float(learning_rate)
        self._parameter_list: Optional[List[torch.nn.Parameter]] = parameters
        self._learning_rate = learning_rate
        self._grad_clip: Optional[ClipGradBase] = grad_clip
        self._weight_decay = (None if weight_decay is None
                              else float(weight_decay))
        self._multi_precision = multi_precision
        # eager step()'s slots, by id(param)
        self._states: Optional[Dict[int, Dict[str, torch.Tensor]]] = None
        self._step_count = 0

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when learning rate is an LRScheduler")
        self._learning_rate = float(value)

    # -- pure per-list update (override these) -----------------------------
    def init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               slots: List[Dict[str, torch.Tensor]], lr: float, step: int):
        """Pure: (new params, new slots) for same-dtype lists."""
        raise NotImplementedError

    def _decoupled(self) -> bool:
        return False                 # AdamW overrides

    def _decoupled_decay(self, params, lr):
        return params                # AdamW overrides

    # -- functional interface (used by jit.TrainStep) ----------------------
    def functional_init(self, params: Sequence[torch.Tensor]):
        states = []
        for p in params:
            s = self.init_slots(p)
            if self._multi_precision and p.dtype in _LOW:
                s["master"] = p.detach().float()
            states.append(s)
        return states

    def functional_update(self, params, grads, states, lr, step,
                          params_meta=None):
        """Pure: ``(new_params, new_states)``.  Clip first, then the
        (coupled) weight decay, then the update, as paddle_tpu's
        ``functional_update``; a parameter with a ``master`` slot is
        updated through it in f32."""
        if self._grad_clip is not None:
            meta = params_meta or [None] * len(params)
            grads = [g for _, g in self._grad_clip(list(zip(meta, grads)))]
        if self._weight_decay is not None and not self._decoupled():
            grads = torch._foreach_add(
                grads, [p.to(g.dtype) for p, g in zip(params, grads)],
                alpha=self._weight_decay)
        work = [s["master"] if "master" in s else p
                for p, s in zip(params, states)]
        grads = [g.to(w.dtype) for g, w in zip(grads, work)]
        sub = [{k: v for k, v in s.items() if k != "master"} for s in states]
        work = self._decoupled_decay(work, lr)
        new_work, new_sub = self.update(work, grads, sub, lr, step)
        new_ps, new_ss = [], []
        for p, s, w, ns in zip(params, states, new_work, new_sub):
            if "master" in s:
                ns["master"] = w
                w = w.to(p.dtype)
            new_ps.append(w)
            new_ss.append(ns)
        return new_ps, new_ss

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Static mode: attach this optimizer to the loss's Program (the
        static Executor computes the gradients and applies the update
        in each run).  Eager: backward, then step."""
        from ..static.program import Variable
        if isinstance(loss, Variable):
            loss.program._optimizer = (self, loss, parameters, no_grad_set)
            return None, None
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in (self._parameter_list or [])]

    # -- eager step --------------------------------------------------------
    @torch.no_grad()
    def step(self):
        if self._parameter_list is None:
            raise ValueError("optimizer constructed without parameters")
        self._step_count += 1
        params = [p for p in self._parameter_list if p.grad is not None]
        if self._states is None:
            self._states = {}
        states = [self._states.get(id(p)) for p in params]
        fresh = [i for i, s in enumerate(states) if s is None]
        for i, s in zip(fresh, self.functional_init([params[i]
                                                     for i in fresh])):
            states[i] = s
        new_p, new_s = self.functional_update(
            [p.detach() for p in params], [p.grad for p in params], states,
            self.get_lr(), self._step_count, params_meta=params)
        torch._foreach_copy_([p.data for p in params], new_p)
        for p, s in zip(params, new_s):
            self._states[id(p)] = s

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if lazy_mode:
            raise NotImplementedError("lazy_mode (SelectedRows) Adam is "
                                      "not ported")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_slots(self, p):
        dt = torch.float32 if p.dtype in _LOW else p.dtype
        return {"m": torch.zeros_like(p, dtype=dt),
                "v": torch.zeros_like(p, dtype=dt)}

    def update(self, params, grads, slots, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        m = torch._foreach_add(torch._foreach_mul([s["m"] for s in slots],
                                                  b1),
                               torch._foreach_mul(grads, 1.0 - b1))
        v = torch._foreach_mul([s["v"] for s in slots], b2)
        torch._foreach_addcmul_(v, torch._foreach_mul(grads, 1.0 - b2),
                                grads)
        # bias correction 1 - beta ** step (a device step: in f64, then
        # f32, the type a Python scalar takes in f32 arithmetic)
        if isinstance(step, torch.Tensor):
            st = step.double()
            bc1, bc2 = 1.0 - b1 ** st, 1.0 - b2 ** st
            m_scale, bc2 = (lr / bc1).float(), bc2.float()
        else:
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            m_scale = lr / bc1
        denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(torch._foreach_mul(m, m_scale), denom)
        new_p = torch._foreach_sub(params, upd)
        return new_p, [{"m": a, "v": b} for a, b in zip(m, v)]


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p - lr * coeff * p`` before
    the update (on the master weights under ``multi_precision``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError("AdamW: lr_ratio and "
                                      "apply_decay_param_fun are not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = float(weight_decay)

    def _decoupled(self):
        return True

    def _decoupled_decay(self, params, lr):
        return torch._foreach_sub(params, torch._foreach_mul(
            params, lr * self._coeff))
