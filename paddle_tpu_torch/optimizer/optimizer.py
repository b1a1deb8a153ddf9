"""Optimizer base, SGD, Momentum, Adam and AdamW
(paddle_tpu.optimizer.optimizer).

Every optimizer defines two pure functions over tensors, as in
paddle_tpu: ``init_slots`` and the list-wise ``update``, shared by

- :meth:`Optimizer.functional_update` (pure: returns new parameter and
  slot tensors; ``jit.TrainStep`` writes them back in place), and
- the eager :meth:`Optimizer.step` (reads the parameters' gradients;
  a sparse embedding gradient as a ``SelectedRows``, updated row-wise
  by SGD and ``Adam(lazy_mode=True)``).

The update runs as PyTorch's multi-tensor ``_foreach`` ops over all
parameters at once, in plain arithmetic.  The fused kernel (K3,
``ops.fused_adam``) takes over from it only in the static Executor, for
a plain f32 Adam, as in paddle_tpu.

The eager ``step`` and ``functional_update`` run paddle_tpu's order:
clip the gradients first, then add the weight decay (a parameter's own
``regularizer`` wins over the optimizer's ``weight_decay``, an
:class:`~.regularizer.L2Decay` when given as a float), then update with
the learning rate times the parameter's ``optimize_attr
["learning_rate"]`` (``ParamAttr(learning_rate=...)``).  Parameters
with the same factor update as one list.  Parameter groups (a list of
``{"params": [...]}``) are flattened into one list, as in paddle_tpu.

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

import numpy as np
import torch

from ..core.selected_rows import SelectedRows, sparse_grad
from ..core.tensor import raw_grad, wrap
from .clip import ClipGradBase
from .lr import LRScheduler
from .regularizer import L2Decay, WeightDecayRegularizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]

_LOW = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                parameters = [p for group in parameters
                              for p in group["params"]]
        if isinstance(weight_decay, (int, float)):
            weight_decay = L2Decay(float(weight_decay))
        if not isinstance(learning_rate, LRScheduler):
            learning_rate = float(learning_rate)
        self._parameter_list: Optional[List[torch.nn.Parameter]] = parameters
        self._learning_rate = learning_rate
        self._grad_clip: Optional[ClipGradBase] = grad_clip
        self._weight_decay: Optional[WeightDecayRegularizer] = weight_decay
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

    def _decoupled_decay(self, params, lr, meta):
        return params                # AdamW overrides

    def _param_lr_ratio(self, param) -> float:
        return 1.0                   # AdamW's lr_ratio overrides

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
        ``functional_update``; ``params_meta`` (the Parameters) carries
        each one's regularizer and learning-rate factor.  A parameter
        with a ``master`` slot is updated through it in f32."""
        meta = params_meta or [None] * len(params)
        grads = self._clipped(grads, meta)
        return self._decay_and_update(params, grads, states, lr, step, meta)

    def _clipped(self, grads, meta):
        if self._grad_clip is None:
            return grads
        return [g for _, g in self._grad_clip(list(zip(meta, grads)))]

    def _lr_factor(self, m) -> float:
        return float(getattr(m, "optimize_attr", {}).get(
            "learning_rate", 1.0)) * self._param_lr_ratio(m)

    def _decay_and_update(self, params, grads, states, lr, step, meta,
                          decay=None):
        """The coupled weight decay (on every parameter, or where
        ``decay``, a list of bools, says), then the update, one list a
        learning-rate factor."""
        if not self._decoupled():
            grads = self._regularized(params, grads, meta, decay)
        factors = [self._lr_factor(m) for m in meta]
        if all(f == 1.0 for f in factors):
            return self._update_list(params, grads, states, lr, step, meta)
        new_ps, new_ss = [None] * len(params), [None] * len(params)
        for f in sorted(set(factors)):
            idx = [i for i, x in enumerate(factors) if x == f]
            ps, ss = self._update_list([params[i] for i in idx],
                                       [grads[i] for i in idx],
                                       [states[i] for i in idx], lr * f,
                                       step, [meta[i] for i in idx])
            for i, a, b in zip(idx, ps, ss):
                new_ps[i], new_ss[i] = a, b
        return new_ps, new_ss

    def _regularized(self, params, grads, meta, decay=None):
        """The gradients with each parameter's regularizer (its own,
        else the optimizer's) added, one multi-tensor op a
        regularizer."""
        regs = [getattr(m, "regularizer", None) or self._weight_decay
                for m in meta]
        if decay is not None:
            regs = [r if d else None for r, d in zip(regs, decay)]
        if all(r is None for r in regs):
            return grads
        if all(r is regs[0] for r in regs):
            return regs[0]._apply(params, grads)
        grads = list(grads)
        for reg in {id(r): r for r in regs if r is not None}.values():
            idx = [i for i, r in enumerate(regs) if r is reg]
            for i, g in zip(idx, reg._apply([params[i] for i in idx],
                                            [grads[i] for i in idx])):
                grads[i] = g
        return grads

    def _update_list(self, params, grads, states, lr, step, meta):
        """One learning rate's update of a list (masters in f32)."""
        work = [s["master"] if "master" in s else p
                for p, s in zip(params, states)]
        grads = [g.to(w.dtype) for g, w in zip(grads, work)]
        sub = [{k: v for k, v in s.items() if k != "master"} for s in states]
        work = self._decoupled_decay(work, lr, meta)
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
        """One update from the parameters' gradients, in
        :meth:`functional_update`'s order.  A sparse embedding gradient
        is read as a :class:`SelectedRows`: the clip sees it merged, and
        :meth:`_apply_rows` takes it off before the weight decay and the
        dense update."""
        if self._parameter_list is None:
            raise ValueError("optimizer constructed without parameters")
        self._step_count += 1
        params = [p for p in self._parameter_list
                  if p.requires_grad and raw_grad(p) is not None]
        if self._states is None:
            self._states = {}
        states = [self._states.get(id(p)) for p in params]
        fresh = [i for i, s in enumerate(states) if s is None]
        for i, s in zip(fresh, self.functional_init([params[i]
                                                     for i in fresh])):
            states[i] = s
        lr, step = self.get_lr(), self._step_count
        grads = self._clipped([sparse_grad(raw_grad(p)) for p in params],
                              params)
        decay = None
        if any(isinstance(g, SelectedRows) for g in grads):
            params, grads, states, decay = self._apply_rows(
                params, grads, states, lr, step)
        if not params:
            return
        new_p, new_s = self._decay_and_update(
            [p.detach() for p in params], grads, states, lr, step, params,
            decay)
        torch._foreach_copy_([p.data for p in params], new_p)
        for p, s in zip(params, new_s):
            self._states[id(p)] = s

    # -- sparse (SelectedRows) updates -------------------------------------
    def _apply_rows(self, params, grads, states, lr, step):
        """The sparse gradients' part of a step, in paddle_tpu's order:
        each SelectedRows is merged (a no-op after the clip's merge); an
        optimizer with a row-wise update (SGD, ``Adam(lazy_mode=True)``)
        then moves only its rows, in place, and any other, or a
        parameter with f32 master weights, takes it dense.  Weight decay
        skips every sparse gradient.  Returns the parameters left for the
        dense update, their gradients and slots, and whether each takes
        the weight decay."""
        keep, decay = [], []
        for i, (p, g) in enumerate(zip(params, grads)):
            if not isinstance(g, SelectedRows):
                keep.append(i)
                decay.append(True)
                continue
            g = g.merge()
            if "master" in states[i] or not self._sparse_supported():
                grads[i] = g.to_dense()
                keep.append(i)
                decay.append(False)
                continue
            self._states[id(p)] = self._sparse_update(
                p.detach(), g, states[i], lr * self._lr_factor(p), step)
        return ([params[i] for i in keep], [grads[i] for i in keep],
                [states[i] for i in keep], decay)

    def _sparse_supported(self) -> bool:
        """Whether this optimizer updates a merged SelectedRows row-wise
        (paddle_tpu: SGD, and Adam in ``lazy_mode``)."""
        return False

    def _sparse_update(self, p, sr, slots, lr, step):
        """Update ``p``'s rows ``sr.rows`` (unique) in place; returns
        the slots."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad

    # -- state dict --------------------------------------------------------
    def state_dict(self):
        """``{"step": n, "slots": {str(i): {name: Tensor}}}`` (the eager
        step's slots by position in the parameter list) and the
        scheduler's state, as paddle_tpu saves it."""
        out = {"step": self._step_count, "slots": {}}
        for i, p in enumerate(self._parameter_list or []):
            s = (self._states or {}).get(id(p))
            if s:
                out["slots"][str(i)] = {k: wrap(v.detach())
                                        for k, v in s.items()}
        if isinstance(self._learning_rate, LRScheduler):
            out["lr_scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        """Load :meth:`state_dict`'s output (tensors or arrays); slots go
        to their parameter's device."""
        self._step_count = int(state.get("step", 0))
        slots = state.get("slots", {})
        if self._states is None:
            self._states = {}
        for i, p in enumerate(self._parameter_list or []):
            if str(i) in slots:
                self._states[id(p)] = {
                    k: torch.as_tensor(v).to(p.device).clone()
                    for k, v in slots[str(i)].items()}
        if (isinstance(self._learning_rate, LRScheduler)
                and "lr_scheduler" in state):
            self._learning_rate.set_state_dict(state["lr_scheduler"])


class SGD(Optimizer):
    """``p - lr * g``."""

    def update(self, params, grads, slots, lr, step):
        grads = [g.to(p.dtype) for p, g in zip(params, grads)]
        return torch._foreach_sub(params, torch._foreach_mul(grads, lr)), \
            slots

    def _sparse_supported(self):
        return True

    def _sparse_update(self, p, sr, slots, lr, step):
        """The rows' scatter update: untouched rows are never read or
        written."""
        p.index_add_(0, sr.rows, sr.values.to(p.dtype) * -lr)
        return slots


class Momentum(Optimizer):
    """``v = momentum * v + g``; ``p - lr * v``, or ``p - lr * (g +
    momentum * v)`` with ``use_nesterov``.  The velocity is f32 under
    ``multi_precision``, else the parameter's dtype."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)

    def init_slots(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        return {"velocity": torch.zeros_like(p, dtype=dt)}

    def update(self, params, grads, slots, lr, step):
        grads = [g.to(p.dtype) for p, g in zip(params, grads)]
        v = torch._foreach_add(torch._foreach_mul(
            [s["velocity"] for s in slots], self._momentum), grads)
        if self._use_nesterov:
            d = torch._foreach_add(grads, torch._foreach_mul(
                v, self._momentum))
        else:
            d = v
        new_p = torch._foreach_sub(params, torch._foreach_mul(d, lr))
        return new_p, [{"velocity": a} for a in v]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lazy = bool(lazy_mode)

    def _sparse_supported(self):
        return self._lazy

    def _sparse_update(self, p, sr, slots, lr, step):
        """``lazy_mode``: the moments and the parameter move on the
        touched rows only, with the bias corrections at the global step
        count; untouched rows keep stale moments (paddle_tpu's lazy
        Adam, in its arithmetic)."""
        b1, b2, eps = self._beta1, self._beta2, self._eps
        rows, m, v = sr.rows, slots["m"], slots["v"]
        g = sr.values.to(m.dtype)
        m_r = b1 * m.index_select(0, rows) + (1 - b1) * g
        v_r = b2 * v.index_select(0, rows) + (1 - b2) * g * g
        # the bias corrections in f32, as paddle_tpu takes them
        one, st = np.float32(1.0), np.float32(step)
        mhat = m_r / float(one - np.float32(b1) ** st)
        vhat = v_r / float(one - np.float32(b2) ** st)
        upd = lr * mhat / (torch.sqrt(vhat) + eps)
        p.index_add_(0, rows, -upd.to(p.dtype))
        m.index_copy_(0, rows, m_r)
        v.index_copy_(0, rows, v_r)
        return slots

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
    the update (on the master weights under ``multi_precision``).
    ``weight_decay`` is the coefficient or an ``L2Decay`` holding it;
    ``apply_decay_param_fun(name)`` says which parameters decay (by
    their ``param_name``; a parameter without one decays), and
    ``lr_ratio(param)`` scales a parameter's learning rate, decay
    included, as in paddle_tpu."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = (weight_decay.coeff if isinstance(weight_decay, L2Decay)
                       else float(weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled(self):
        return True

    def _param_lr_ratio(self, param):
        if self._lr_ratio is None or param is None:
            return 1.0
        return float(self._lr_ratio(param))

    def _decoupled_decay(self, params, lr, meta):
        fn = self._apply_decay_param_fun
        decay = [fn is None or getattr(m, "param_name", None) is None
                 or fn(m.param_name) for m in meta]
        if not any(decay):
            return params
        idx = [i for i, d in enumerate(decay) if d]
        sub = [params[i] for i in idx]
        out = list(params)
        for i, p in zip(idx, torch._foreach_sub(
                sub, torch._foreach_mul(sub, lr * self._coeff))):
            out[i] = p
        return out
