"""The optimizers of paddle_tpu.optimizer.optimizer: the base, SGD,
Momentum, Adam and AdamW, and the tail (Adamax, Adagrad, Adadelta,
RMSProp, Lamb, LarsMomentum, Ftrl, Dpsgd, ProximalGD, ProximalAdagrad,
DecayedAdagrad).

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

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "Ftrl",
           "Dpsgd", "ProximalGD", "ProximalAdagrad", "DecayedAdagrad"]

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
        # a static program's slots live in the Executor's state, keyed by
        # position in program.parameters() (paddle_tpu's protocol); read
        # only when there are no eager slots, so the two index spaces
        # never mix
        prov = getattr(self, "_static_state_provider", None)
        if prov is not None and not out["slots"]:
            st = prov()
            if st is not None:
                out["slots"].update(st.export_slots())
        if isinstance(self._learning_rate, LRScheduler):
            out["lr_scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        """Load :meth:`state_dict`'s output (tensors or arrays); slots go
        to their parameter's device."""
        self._step_count = int(state.get("step", 0))
        # a bound step that keeps its own state (LocalSGD's replicas)
        # starts again from the loaded counter and the model's weights
        bound = getattr(self, "_bound_train_step", None)
        if bound is not None:
            bound._scaler_state = None
        slots = state.get("slots", {})
        if self._states is None:
            self._states = {}
        for i, p in enumerate(self._parameter_list or []):
            if str(i) in slots:
                self._states[id(p)] = {
                    k: torch.as_tensor(v).to(p.device).clone()
                    for k, v in slots[str(i)].items()}
        if not self._parameter_list and slots:
            # a static program's: staged for the Executor, keyed by
            # position in program.parameters(); a live Executor state
            # takes them in place (its fused-Adam table points at them)
            staged = {k: {sk: torch.as_tensor(np.asarray(v)) if not
                          isinstance(v, torch.Tensor) else v
                          for sk, v in sl.items()}
                      for k, sl in slots.items()}
            prov = getattr(self, "_static_state_provider", None)
            st = prov() if prov is not None else None
            if st is not None:
                by_pos = {pos: pid for pid, pos in st.position.items()}
                with torch.no_grad():
                    for k in list(staged):
                        live = st.slots.get(by_pos.get(int(k)))
                        if live:
                            for sk, v in staged.pop(k).items():
                                live[sk].copy_(v.to(live[sk].device,
                                                    live[sk].dtype))
                st.step.fill_(float(self._step_count))
            self._static_pending_slots = staged or None
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


# -- the tail: paddle_tpu/optimizer/optimizer.py's other optimizers --------
def _slot_dtype(opt, p):
    """f32 for a bf16/f16 parameter with a master copy, else its own."""
    return (torch.float32 if opt._multi_precision and p.dtype in _LOW
            else p.dtype)


def _zeros(opt, p):
    return torch.zeros_like(p, dtype=_slot_dtype(opt, p))


def _bias_correction(beta: float, step):
    """``1 - beta ** step`` in f32, as paddle_tpu takes it (``step`` an
    int, or a 0-d device tensor: then a 0-d f32 tensor, no host read)."""
    if isinstance(step, torch.Tensor):
        return 1.0 - torch.pow(torch.tensor(beta, dtype=torch.float32,
                                            device=step.device),
                               step.float())
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(step))


def _norms(ts):
    """Each tensor's L2 norm, stacked into one f32 vector (one
    multi-tensor reduction; nothing is read on the host)."""
    return torch.stack(torch._foreach_norm(ts)).float()


def _per_tensor(scale, like):
    """A stacked per-tensor scale as 0-d tensors in each one's dtype."""
    return [s.to(t.dtype) for s, t in zip(scale.unbind(), like)]


class Adamax(Optimizer):
    """``m = b1 m + (1 - b1) g``; ``u = max(b2 u, |g|)``; ``p - lr / (1 -
    b1^t) * m / (u + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_slots(self, p):
        return {"m": _zeros(self, p), "inf": _zeros(self, p)}

    def update(self, params, grads, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = torch._foreach_add(torch._foreach_mul([s["m"] for s in slots],
                                                  b1),
                               torch._foreach_mul(grads, 1.0 - b1))
        u = torch._foreach_maximum(
            torch._foreach_mul([s["inf"] for s in slots], b2),
            torch._foreach_abs(grads))
        scale = lr / _bias_correction(b1, step)
        upd = torch._foreach_div(torch._foreach_mul(m, scale),
                                 torch._foreach_add(u, self._eps))
        return (torch._foreach_sub(params, upd),
                [{"m": a, "inf": b} for a, b in zip(m, u)])


class Adagrad(Optimizer):
    """``mom += g^2``; ``p - lr g / (sqrt(mom) + eps)``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_slots(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=_slot_dtype(self, p))}

    def update(self, params, grads, slots, lr, step):
        mom = torch._foreach_addcmul([s["moment"] for s in slots], grads,
                                     grads)
        denom = torch._foreach_add(torch._foreach_sqrt(mom), self._eps)
        upd = torch._foreach_div(torch._foreach_mul(grads, lr), denom)
        return (torch._foreach_sub(params, upd),
                [{"moment": a} for a in mom])


class Adadelta(Optimizer):
    """``E[g^2] = rho E[g^2] + (1 - rho) g^2``; ``u = g sqrt(E[u^2] +
    eps) / sqrt(E[g^2] + eps)``; ``E[u^2] = rho E[u^2] + (1 - rho) u^2``;
    ``p - lr u``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def init_slots(self, p):
        return {"avg_sq_grad": _zeros(self, p),
                "avg_sq_update": _zeros(self, p)}

    def update(self, params, grads, slots, lr, step):
        rho, eps = self._rho, self._eps
        old_u = [s["avg_sq_update"] for s in slots]
        asg = torch._foreach_mul([s["avg_sq_grad"] for s in slots], rho)
        torch._foreach_addcmul_(asg, torch._foreach_mul(grads, 1.0 - rho),
                                grads)
        upd = torch._foreach_div(
            torch._foreach_mul(grads, torch._foreach_sqrt(
                torch._foreach_add(old_u, eps))),
            torch._foreach_sqrt(torch._foreach_add(asg, eps)))
        asu = torch._foreach_mul(old_u, rho)
        torch._foreach_addcmul_(asu, torch._foreach_mul(upd, 1.0 - rho), upd)
        return (torch._foreach_sub(params, torch._foreach_mul(upd, lr)),
                [{"avg_sq_grad": a, "avg_sq_update": b}
                 for a, b in zip(asg, asu)])


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g^2`` (and, ``centered``, ``mg = rho mg
    + (1 - rho) g``, the denominator ``sqrt(ms - mg^2 + eps)``); ``mom =
    momentum mom + lr g / sqrt(ms + eps)``; ``p - mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_slots(self, p):
        s = {"mean_square": _zeros(self, p), "momentum": _zeros(self, p)}
        if self._centered:
            s["mean_grad"] = _zeros(self, p)
        return s

    def update(self, params, grads, slots, lr, step):
        rho, eps = self._rho, self._eps
        ms = torch._foreach_mul([s["mean_square"] for s in slots], rho)
        torch._foreach_addcmul_(ms, torch._foreach_mul(grads, 1.0 - rho),
                                grads)
        out = [dict(s, mean_square=a) for s, a in zip(slots, ms)]
        if self._centered:
            mg = torch._foreach_add(
                torch._foreach_mul([s["mean_grad"] for s in slots], rho),
                torch._foreach_mul(grads, 1.0 - rho))
            denom = torch._foreach_sqrt(torch._foreach_add(
                torch._foreach_sub(ms, torch._foreach_mul(mg, mg)), eps))
            for o, a in zip(out, mg):
                o["mean_grad"] = a
        else:
            denom = torch._foreach_sqrt(torch._foreach_add(ms, eps))
        mom = torch._foreach_add(
            torch._foreach_mul([s["momentum"] for s in slots],
                               self._momentum),
            torch._foreach_div(torch._foreach_mul(grads, lr), denom))
        for o, a in zip(out, mom):
            o["momentum"] = a
        return torch._foreach_sub(params, mom), out


class Lamb(Optimizer):
    """LAMB (You et al. 2019): Adam's ``r = m^ / (sqrt(v^) + eps) +
    wd p``, scaled per tensor by the trust ratio ``||p|| / ||r||`` (1
    where either norm is 0): ``p - lr trust r``.  The norms are one
    multi-tensor reduction each and the ratio a ``torch.where``, so a
    step reads nothing on the host; the last update's ratios stay on
    the device as ``trust_ratios`` (one per tensor, in order).
    ``exclude_from_weight_decay_fn`` is stored and not used, and there
    is no ``weight_decay=``, as in paddle_tpu."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn
        self.trust_ratios: Optional[torch.Tensor] = None

    def init_slots(self, p):
        return {"m": _zeros(self, p), "v": _zeros(self, p)}

    def update(self, params, grads, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = torch._foreach_add(torch._foreach_mul([s["m"] for s in slots],
                                                  b1),
                               torch._foreach_mul(grads, 1.0 - b1))
        v = torch._foreach_mul([s["v"] for s in slots], b2)
        torch._foreach_addcmul_(v, torch._foreach_mul(grads, 1.0 - b2),
                                grads)
        mhat = torch._foreach_div(m, _bias_correction(b1, step))
        vhat = torch._foreach_div(v, _bias_correction(b2, step))
        r = torch._foreach_div(mhat, torch._foreach_add(
            torch._foreach_sqrt(vhat), self._eps))
        torch._foreach_add_(r, torch._foreach_mul(params, self._wd))
        w_norm, r_norm = _norms(params), _norms(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        self.trust_ratios = trust
        upd = torch._foreach_mul(r, _per_tensor(lr * trust, r))
        return (torch._foreach_sub(params, upd),
                [{"m": a, "v": b} for a, b in zip(m, v)])


class LarsMomentum(Optimizer):
    """LARS (You et al. 2017): a local learning rate ``lr coeff ||p|| /
    (||g|| + wd ||p|| + eps)`` per tensor (``lr`` where either norm is
    0); ``v = momentum v + local_lr (g + wd p)``; ``p - v``.  The norms
    and the rate stay on the device; no ``weight_decay=``, as in
    paddle_tpu."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=0, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon

    def init_slots(self, p):
        return {"velocity": _zeros(self, p)}

    def update(self, params, grads, slots, lr, step):
        wd = self._lars_wd
        w_norm, g_norm = _norms(params), _norms(grads)
        local = torch.where((w_norm > 0) & (g_norm > 0),
                            lr * self._lars_coeff * w_norm
                            / (g_norm + wd * w_norm + self._eps),
                            torch.full_like(w_norm, lr))
        d = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        v = torch._foreach_add(
            torch._foreach_mul([s["velocity"] for s in slots],
                               self._momentum),
            torch._foreach_mul(d, _per_tensor(local, d)))
        return (torch._foreach_sub(params, v),
                [{"velocity": a} for a in v])


class Ftrl(Optimizer):
    """FTRL-Proximal (McMahan et al.): squared and linear accumulators,
    the soft threshold on the linear term; ``lr_power`` in the
    reference's sign convention (-0.5 means ``sqrt`` in the
    denominators)."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0,
                 lr_power=-0.5, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def init_slots(self, p):
        return {"squared": _zeros(self, p), "linear": _zeros(self, p)}

    def update(self, params, grads, slots, lr, step):
        sq = [s["squared"] for s in slots]
        new_sq = torch._foreach_addcmul(sq, grads, grads)
        if self._lr_power == -0.5:
            a, b = torch._foreach_sqrt(new_sq), torch._foreach_sqrt(sq)
        else:
            a = torch._foreach_pow(new_sq, -self._lr_power)
            b = torch._foreach_pow(sq, -self._lr_power)
        sigma = torch._foreach_div(torch._foreach_sub(a, b), lr)
        denom = torch._foreach_div(a, lr)
        new_lin = torch._foreach_sub(
            torch._foreach_add([s["linear"] for s in slots], grads),
            torch._foreach_mul(sigma, params))
        x = torch._foreach_sub(torch._foreach_mul(
            torch._foreach_sign(new_lin), self._l1), new_lin)
        y = torch._foreach_add(denom, 2.0 * self._l2)
        q = torch._foreach_div(x, y)
        new_p = [torch.where(n.abs() > self._l1, v, torch.zeros_like(v))
                 for n, v in zip(new_lin, q)]
        return new_p, [{"squared": a, "linear": b}
                       for a, b in zip(new_sq, new_lin)]


class Dpsgd(Optimizer):
    """Differentially private SGD: each gradient tensor clipped to L2
    norm ``clip`` as a whole, plus one Gaussian draw per tensor (shared
    by its elements) of deviation ``sigma`` scaled by ``1 /
    batch_size``: ``p - lr (g / max(1, ||g|| / clip) + sigma n /
    batch_size)``.

    The draws come from a Philox generator of the parameters' device
    seeded with ``seed`` (``seed=0`` is the literal seed), one vector
    of one draw per tensor each update, so two tensors never share a
    draw and each step draws anew.  paddle_tpu draws from threefry keys
    folded with the step and the tensor's index: the same seed gives
    other numbers here (:meth:`_draw` is where they come from)."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, seed=0, parameters=None, name=None):
        super().__init__(learning_rate, parameters, None, None, name)
        self._clip, self._batch = clip, batch_size
        self._sigma, self._seed = sigma, seed
        self._gens: Dict[torch.device, torch.Generator] = {}

    def _draw(self, step, n: int, device) -> torch.Tensor:
        """``n`` standard normal draws (f32) on ``device``."""
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
            gen.manual_seed(int(self._seed))
        return torch.randn(n, generator=gen, device=device)

    def update(self, params, grads, slots, lr, step):
        norm = _norms([g.float() for g in grads])
        scale = torch.where(norm > self._clip, norm / self._clip,
                            torch.ones_like(norm))
        noise = (self._sigma * self._draw(step, len(params),
                                          params[0].device)) / self._batch
        upd = torch._foreach_add(
            torch._foreach_div(grads, _per_tensor(scale, grads)),
            _per_tensor(noise, grads))
        return (torch._foreach_sub(params, torch._foreach_mul(upd, lr)),
                slots)


class ProximalGD(Optimizer):
    """A gradient step, then the proximal map: the L1 soft threshold
    (when ``l1 > 0``) and the L2 shrink ``1 / (1 + lr l2)``."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._l1, self._l2 = l1, l2

    def _prox(self, prox, lr):
        shrink = 1.0 + lr * self._l2
        if self._l1 > 0:
            mag = torch._foreach_clamp_min(torch._foreach_sub(
                torch._foreach_abs(prox), lr * self._l1), 0.0)
            return torch._foreach_div(torch._foreach_mul(
                torch._foreach_sign(prox), mag), shrink)
        return torch._foreach_div(prox, shrink)

    def update(self, params, grads, slots, lr, step):
        return self._prox(torch._foreach_sub(
            params, torch._foreach_mul(grads, lr)), lr), slots


class ProximalAdagrad(ProximalGD):
    """Adagrad's step ``lr g / sqrt(mom)``, then ProximalGD's map.  An
    element whose accumulator is still 0 takes a zero step (the
    reference's kernel divides 0 by 0 there), as in paddle_tpu."""

    def init_slots(self, p):
        return {"moment": _zeros(self, p)}

    def update(self, params, grads, slots, lr, step):
        mom = torch._foreach_addcmul([s["moment"] for s in slots], grads,
                                     grads)
        steps = []
        for g, m in zip(grads, mom):
            live = m > 0
            safe = torch.where(live, m, torch.ones_like(m))
            steps.append(torch.where(live, lr * g / torch.sqrt(safe),
                                     torch.zeros_like(g)))
        return (self._prox(torch._foreach_sub(params, steps), lr),
                [{"moment": a} for a in mom])


class DecayedAdagrad(Optimizer):
    """Adagrad with a decayed accumulator: ``mom = decay mom + (1 -
    decay) g^2``; ``p - lr g / (sqrt(mom) + eps)``."""

    def __init__(self, learning_rate=0.001, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._decay, self._eps = decay, epsilon

    def init_slots(self, p):
        return {"moment": _zeros(self, p)}

    def update(self, params, grads, slots, lr, step):
        d = self._decay
        mom = torch._foreach_mul([s["moment"] for s in slots], d)
        torch._foreach_addcmul_(mom, torch._foreach_mul(grads, 1.0 - d),
                                grads)
        denom = torch._foreach_add(torch._foreach_sqrt(mom), self._eps)
        upd = torch._foreach_div(torch._foreach_mul(grads, lr), denom)
        return (torch._foreach_sub(params, upd),
                [{"moment": a} for a in mom])
