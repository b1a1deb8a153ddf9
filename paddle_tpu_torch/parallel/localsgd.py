"""LocalSGD and adaptive LocalSGD: parameter averaging every k steps (the
counterpart of ``paddle_tpu/parallel/localsgd.py``).

As in the JAX package (after fleet's ``localsgd_optimizer.py``):

- every rank of the 'dp' axis is one replica: it trains its own copy of
  the parameters, buffers and optimizer slots on its dp slice of the
  batch with the inner optimizer, and no gradient is all-reduced;
- the parameters (and buffers) are averaged over 'dp' every step while
  ``step <= begin_step``, then every ``k_steps`` steps;
- adaptive LocalSGD sets k again at each sync after the warm-up:
  ``k = clip(ceil(sqrt(lr_0 * loss / (lr * loss_0) * init_k)), 1, 16)``,
  with ``loss_0`` and ``lr_0`` taken at the warm-up syncs (or the first
  sync when there is none), in f32 as the JAX step computes it;
- the optimizer slots stay local.

The replicas live apart from the model (the step runs the model through
``torch.func.functional_call`` on them), so the model's own parameters
are what :meth:`LocalSGDTrainStep.sync_to_model` last wrote: the mean of
the replicas, a collective every rank calls.  ``Layer.state_dict`` and
fleet's persistence call it first.  A non-sync step runs no collective
but the loss's mean.  ``optimizer.set_state_dict`` drops the replicas,
so the next step starts again from the model's parameters.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..core import rng
from ..distributed.collective import ReduceOp, all_reduce, axis_group
from ..distributed.mesh import DP_AXIS, ensure_mesh
from ..distributed.strategy import DistributedStrategy, validate_toggles

__all__ = ["LocalSGDTrainStep"]


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class _WithLoss(torch.nn.Module):
    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, inputs, labels):
        return self.loss_fn(self.model(*inputs), *labels)


class LocalSGDTrainStep:
    """LocalSGD step: per-replica local updates and a periodic mean.

    ``adaptive=True`` (default: ``strategy.adaptive_localsgd``) enables
    the adaptive k schedule.  The model's parameters are not written
    each step: call :meth:`sync_to_model` before reading weights out of
    the model directly."""

    K_MIN, K_MAX = 1, 16   # localsgd_optimizer.py:425-428
    scaler = None

    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 strategy: Optional[DistributedStrategy] = None,
                 n_inputs: int = 1, adaptive: Optional[bool] = None):
        strategy = strategy or DistributedStrategy()
        validate_toggles(strategy)
        # the composable toggles are wired below (amp bf16 autocast,
        # recompute); the rest must be loud, not silently dropped
        unsupported = [t for t in ("sharding", "gradient_merge",
                                   "fp16_allreduce", "tensor_parallel",
                                   "pipeline", "sequence_parallel")
                       if getattr(strategy, t)]
        if unsupported:
            raise NotImplementedError(
                f"strategy.localsgd does not compose with {unsupported}: "
                f"LocalSGD keeps full per-replica params/slots on each dp "
                f"shard (the reference restricts it similarly, "
                f"localsgd_optimizer.py:27-31 black_list).  Drop the "
                f"toggle(s) or use plain SpmdTrainStep.")
        if strategy.amp and strategy.amp_configs.dtype == "float16":
            raise NotImplementedError(
                "localsgd + float16 dynamic loss scaling is not wired; "
                "use amp_configs.dtype='bfloat16' (no scaler needed).")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_inputs = n_inputs
        self.mesh = mesh or ensure_mesh()
        self.strategy = strategy
        self._amp = bool(strategy.amp)
        self._recompute = bool(strategy.recompute)
        if adaptive is None:
            adaptive = strategy.adaptive_localsgd
        self.adaptive = bool(adaptive)
        cfg = (strategy.adaptive_localsgd_configs if self.adaptive
               else strategy.localsgd_configs)
        self._k0 = int(cfg.init_k_steps if self.adaptive else cfg.k_steps)
        self._begin = int(cfg.begin_step)
        others = [a for a, s in self.mesh.shape.items()
                  if a != DP_AXIS and s > 1]
        if others:
            raise NotImplementedError(
                f"LocalSGD averages full param replicas over 'dp'; model "
                f"shardings over {others} are not composable with it "
                f"(the reference restricts it to collective DP too, "
                f"localsgd_optimizer.py:34-47).")
        self.g = axis_group(DP_AXIS, self.mesh)
        self.dp = self.g.nranks
        self._named = list(model.named_parameters())
        self._params = [p for _, p in self._named]
        self._bnames = [n for n, _ in model.named_buffers()]
        self._with_loss = _WithLoss(model, loss_fn)
        self._p_rep = None
        self._b_rep = None
        self._s_rep = None
        self._aux = None
        self._model_dirty = False
        optimizer._bound_train_step = self

    # -- the replica store -------------------------------------------------
    def _init_state(self):
        for p in self._params:
            p._param_owner_step = weakref.ref(self)   # state_dict syncs
        self._p_rep = [p.detach().clone() for p in self._params]
        bufs = dict(self.model.named_buffers())
        self._b_rep = [bufs[n].detach().clone() for n in self._bnames]
        self._s_rep = self.optimizer.functional_init(self._p_rep)
        # seeded from the optimizer's host count, so a set_state_dict
        # before a (re)start is honoured
        start = int(self.optimizer._step_count)
        self._aux = {"step": start, "last": start, "k": self._k0,
                     "loss0": np.float32(0.0), "lr0": np.float32(0.0)}

    # the optimizer's checkpoint protocol: set_state_dict resets the
    # bound step's state, and loaded weights then win over the replicas
    @property
    def _scaler_state(self):
        return self._aux

    @_scaler_state.setter
    def _scaler_state(self, value):
        if value is None:
            self._p_rep = self._b_rep = self._s_rep = None
        self._aux = value

    # -- one step ----------------------------------------------------------
    def _slice(self, t):
        t = _as_tensor(t)
        if self.dp == 1:
            return t
        per = t.shape[0] // self.dp
        return t[self.g.rank * per:(self.g.rank + 1) * per]

    def _local_loss(self, leaves, inputs, labels):
        # the loss runs inside the call too: a loss that reads the
        # model's parameters (a tied head) reads the replica's
        names = [n for n, _ in self._named]
        state = {f"model.{n}": t for n, t in zip(names, leaves)}
        state.update((f"model.{n}", t)
                     for n, t in zip(self._bnames, self._b_rep))

        def loss_of(*ins):
            return functional_call(self._with_loss, state, (ins, labels))

        def run(*ins):
            if self._recompute:
                from .recompute import recompute
                return recompute(loss_of, *ins)
            return loss_of(*ins)

        if not self._amp:
            return run(*inputs)
        from ..amp import auto_cast
        with auto_cast(level="O1", dtype=self.strategy.amp_configs.dtype):
            return run(*inputs)

    def _mean_over_dp(self, tensors):
        """Every replica's tensors replaced by their mean over 'dp' (f32,
        one all-reduce of one flat buffer)."""
        if self.dp == 1 or not tensors:
            return
        flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
        all_reduce(flat, group=self.g)
        flat /= self.dp
        off = 0
        with torch.no_grad():
            for t in tensors:
                n = t.numel()
                t.copy_(flat[off:off + n].reshape(t.shape).to(t.dtype))
                off += n

    def __call__(self, *batch):
        inputs = tuple(_as_tensor(b) for b in batch[:self.n_inputs])
        labels = tuple(_as_tensor(b) for b in batch[self.n_inputs:])
        if inputs[0].shape[0] % self.dp:
            raise ValueError(
                f"batch size {inputs[0].shape[0]} not divisible by "
                f"dp={self.dp}")
        if self._p_rep is None:
            self._init_state()
        aux = self._aux
        self.optimizer._step_count += 1
        lr = float(self.optimizer.get_lr())
        attempt = aux["step"] + 1
        ins = tuple(self._slice(t) for t in inputs)
        labs = tuple(self._slice(t) for t in labels)
        leaves = [t.detach().requires_grad_(p.requires_grad)
                  for t, p in zip(self._p_rep, self._params)]
        # each replica draws its own dropout masks
        with rng.fold_in(self.g.rank), torch.enable_grad():
            loss = self._local_loss(leaves, ins, labs)
            train = [k for k, t in enumerate(leaves) if t.requires_grad]
            got = torch.autograd.grad(loss, [leaves[k] for k in train],
                                      allow_unused=True)
        grads = [torch.zeros_like(t) for t in self._p_rep]
        for k, g in zip(train, got):
            if g is not None:
                grads[k] = g
        with torch.no_grad():
            new_p, new_s = self.optimizer.functional_update(
                list(self._p_rep), grads, self._s_rep, lr, attempt,
                params_meta=self._params)
            for k in train:
                self._p_rep[k].copy_(new_p[k])
            for old, new in zip(self._s_rep, new_s):
                for key, t in new.items():
                    old[key].copy_(t)
        loss_avg = all_reduce(loss.detach().float().clone(), ReduceOp.AVG,
                              self.g)
        # the sync predicate (localsgd_optimizer.py:188-190): every step
        # while attempt <= begin_step, then every k steps after
        warm = attempt <= self._begin
        sync = warm or (attempt - aux["last"]) >= aux["k"]
        if sync:
            self._mean_over_dp(self._p_rep + self._b_rep)
        new_aux = dict(aux, step=attempt,
                       last=attempt if sync else aux["last"])
        if self.adaptive and sync:
            loss_f = np.float32(float(loss_avg))
            lr_f = np.float32(lr)
            captured = aux["loss0"] > 0
            # loss_0 / lr_0 at the warm-up syncs, or at the first sync
            # ever when begin_step skipped the warm-up
            grab = warm or not captured
            loss0 = loss_f if grab else aux["loss0"]
            lr0 = lr_f if grab else aux["lr0"]
            if not warm and captured and not grab:
                ratio = np.float32(lr0 * loss_f) / np.float32(
                    lr_f * loss0 + np.float32(1e-12))
                k_next = int(np.ceil(np.sqrt(np.float32(
                    ratio * np.float32(self._k0)))))
                new_aux["k"] = min(max(k_next, self.K_MIN), self.K_MAX)
            new_aux.update(loss0=loss0, lr0=lr0)
        self._aux = new_aux
        self._model_dirty = True
        return loss_avg

    @property
    def k_steps(self) -> int:
        """The current (possibly adapted) sync interval."""
        return int(self._aux["k"]) if self._aux is not None else self._k0

    def sync_params(self):
        """The unified step contract (``TrainStep.sync_params``): the
        authoritative weights into the model."""
        self.sync_to_model()

    def sync_to_model(self):
        """The mean of the dp replicas into the model's parameters and
        buffers (a collective: every rank calls it).  The replicas train
        on as they were."""
        if self._p_rep is None or not self._model_dirty:
            return
        self._model_dirty = False
        tensors = [t.detach().clone() for t in self._p_rep + self._b_rep]
        self._mean_over_dp(tensors)
        bufs = dict(self.model.named_buffers())
        with torch.no_grad():
            for p, t in zip(self._params, tensors):
                p.copy_(t)
            for n, t in zip(self._bnames, tensors[len(self._params):]):
                bufs[n].copy_(t)

    def __repr__(self):
        return (f"LocalSGDTrainStep(dp={self.dp}, adaptive={self.adaptive},"
                f" k={self.k_steps}, begin={self._begin})")

