"""TrainStep (paddle_tpu.jit.train_step): one call runs forward,
backward, gradient clip and optimizer update.

PyTorch runs it eagerly, kernel by kernel; there is no compiled
program.  The parameters and optimizer slots are updated in place
after the optimizer's pure ``functional_update``, which stands in for
the JAX step's donated buffers: ``donate`` is accepted and has no
effect.  Dropout draws anew at every call (``F.dropout`` from the
device generator, flash attention from ``core.rng.next_seed``), so two
steps never share a mask.

What the JAX step compiles in, this one runs in the same order:

- ``recompute=True``: the whole loss is one recomputed segment
  (``parallel.recompute``): only the inputs are kept, and the backward
  runs the forward again with the same dropout draws;
- ``accumulate_steps=K``: the batch is cut into K microbatches along
  dim 0 (it must divide), each with a random stream of its own
  (``core.rng.fold_in(k)``, as the JAX step folds ``k`` into its key);
  the gradients are summed in f32 and the loss and gradients are their
  means;
- ``scaler=GradScaler``: the loss is scaled, the gradients unscaled,
  and a step whose gradients are not all finite updates nothing (not
  even Adam's count of steps); the scale grows and shrinks as the
  scaler says.  The scale, the counters, the overflow flag and the
  applied-step count live on the device (``torch.where``, no host
  read in the step); ``scaler.state_dict()`` reads them;
- ``amp_level``: the forward and the loss run under
  ``amp.auto_cast(amp_level, model._amp_dtype)`` (bf16 unless
  ``amp.decorate`` recorded another type).

The learning rate is ``optimizer.get_lr()``, read at every call, so an
LR schedule the loop moves is followed.

Buffers the forward updates (batch norm's running statistics) change
in place as the forward runs, as often as the JAX step's threaded
buffers do: once a microbatch, in order; once under ``recompute`` (the
backward's replay leaves them, ``core.autograd.replaying``); and on a
loss-scaled step that is skipped too, where only the parameters and
the optimizer's slots are held back.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..core import rng

__all__ = ["TrainStep"]


class TrainStep:
    """``loss = loss_fn(model(*inputs), *labels)`` + clip + update.

    Usage::

        step = TrainStep(model, loss_fn, opt)       # loss_fn(outputs, labels)
        loss = step(x, y)                            # a 0-d tensor

    The returned loss is computed before the update, as in paddle_tpu;
    reading it (``float(loss)``) waits for the device.
    """

    def __init__(self, model, loss_fn: Callable, optimizer,
                 n_inputs: int = 1, donate: bool = False, scaler=None,
                 accumulate_steps: int = 1, amp_level: Optional[str] = None,
                 recompute: bool = False):
        if int(accumulate_steps) < 1:
            raise ValueError(f"accumulate_steps={accumulate_steps}: at "
                             "least 1")
        if amp_level not in (None, "O1", "O2"):
            raise ValueError(f"amp_level {amp_level!r}: None, O1 or O2")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_inputs = n_inputs
        self.donate = donate
        self.scaler = (scaler if scaler is not None
                       and getattr(scaler, "_enable", True) else None)
        self.accumulate_steps = int(accumulate_steps)
        self.amp_level = amp_level
        self._recompute = bool(recompute)
        self._params = [p for _, p in model.named_parameters()]
        self._opt_state = None
        # loss scaling's device state (scale, good, bad, found_inf, and
        # step: the updates applied); None until the first call
        self._scaler_state = None
        if self.scaler is not None:
            self.scaler._bound_step = self

    @property
    def loss_scale(self) -> Optional[float]:
        """The current loss scale (a host read; for logs and
        checkpoints)."""
        st = self._scaler_state
        return None if st is None else float(st["scale"])

    def _amp_scope(self):
        if self.amp_level is None:
            return contextlib.nullcontext()
        from ..amp import auto_cast
        return auto_cast(level=self.amp_level,
                         dtype=getattr(self.model, "_amp_dtype",
                                       torch.bfloat16))

    def _loss(self, inputs, labels):
        with self._amp_scope():
            return self.loss_fn(self.model(*inputs), *labels)

    def _loss_and_grads(self, inputs, labels, scale):
        """One (micro)batch: its loss (unscaled, detached) and the
        gradients of ``loss * scale`` (zero for unused parameters)."""
        if self._recompute:
            from ..parallel.recompute import recompute
            loss = recompute(self._loss, inputs, labels)
        else:
            loss = self._loss(inputs, labels)
        target = loss if scale is None else loss * scale
        grads = torch.autograd.grad(target, self._params, allow_unused=True)
        # a sparse embedding gradient is taken dense here, as paddle_tpu's
        # compiled step takes it
        return loss.detach(), [torch.zeros_like(p) if g is None else
                               g.to_dense() if g.is_sparse else g
                               for p, g in zip(self._params, grads)]

    def _accumulated(self, inputs, labels, scale):
        """K microbatches, each in its own random stream; the mean loss
        and the mean of the f32 gradients."""
        K = self.accumulate_steps
        cut = lambda ts, k: tuple(  # noqa: E731
            t.reshape(K, t.shape[0] // K, *t.shape[1:])[k] for t in ts)
        loss_sum, g_sum = None, None
        for k in range(K):
            with rng.fold_in(k):
                loss, grads = self._loss_and_grads(cut(inputs, k),
                                                   cut(labels, k), scale)
            grads = [g.float() for g in grads]
            if g_sum is None:
                loss_sum, g_sum = loss.float(), grads
            else:
                loss_sum = loss_sum + loss.float()
                torch._foreach_add_(g_sum, grads)
        return loss_sum / K, torch._foreach_div(g_sum, float(K))

    def _init_scaler_state(self, dev):
        sc = self.scaler
        i32 = dict(dtype=torch.int32, device=dev)
        return {"step": torch.tensor(self.optimizer._step_count, **i32),
                "scale": torch.tensor(sc._scale, dtype=torch.float32,
                                      device=dev),
                "good": torch.tensor(sc._good_steps, **i32),
                "bad": torch.tensor(sc._bad_steps, **i32),
                "found_inf": torch.tensor(False, device=dev)}

    def _next_scaler_state(self, st, found_inf, attempt):
        """update_loss_scaling, on the device."""
        sc = self.scaler
        good, bad, scale = st["good"], st["bad"], st["scale"]
        if sc._dynamic:
            good = torch.where(found_inf, 0, good + 1)
            bad = torch.where(found_inf, bad + 1, 0)
            dec = bad >= sc._decr_every
            scale = torch.where(
                dec, torch.clamp_min(scale * sc._decr_ratio, 1.0), scale)
            bad = torch.where(dec, 0, bad)
            inc = good >= sc._incr_every
            scale = torch.where(inc, scale * sc._incr_ratio, scale)
            good = torch.where(inc, 0, good)
        return {"step": torch.where(found_inf, st["step"], attempt),
                "scale": scale, "good": good, "bad": bad,
                "found_inf": found_inf}

    def __call__(self, *batch):
        if len(batch) < self.n_inputs:
            raise ValueError(f"TrainStep expects at least {self.n_inputs} "
                             "input(s)")
        batch = self._prepare_batch(batch)
        inputs, labels = batch[:self.n_inputs], batch[self.n_inputs:]
        K = self.accumulate_steps
        if K > 1 and inputs[0].shape[0] % K:
            raise ValueError(f"batch size {inputs[0].shape[0]} is not "
                             f"divisible by accumulate_steps={K}")
        params = self._params
        if self._opt_state is None:
            self._opt_state = self.optimizer.functional_init(
                self._update_targets())
        st = None
        if self.scaler is not None:
            if self._scaler_state is None:
                self._scaler_state = self._init_scaler_state(
                    params[0].device)
            st = self._scaler_state
        scale = None if st is None else st["scale"]
        if K > 1:
            loss, grads = self._accumulated(inputs, labels, scale)
        else:
            loss, grads = self._loss_and_grads(inputs, labels, scale)
        # reduce first: the overflow check must see the gradients every
        # rank applies, not its own share
        grads = self._reduce_grads(grads)
        if st is not None:
            grads = torch._foreach_mul(grads, 1.0 / scale)
            found_inf = self._reduce_found_inf(torch.logical_not(torch.stack(
                [torch.isfinite(g).all() for g in grads]).all()))
        self.optimizer._step_count += 1
        step = (self.optimizer._step_count if st is None
                else st["step"] + 1)
        with torch.no_grad():
            old = self._update_targets()
            new_p, new_s = self.optimizer.functional_update(
                old, grads, self._opt_state, self.optimizer.get_lr(), step,
                params_meta=params)
            if st is not None:
                # skip the whole update on a non-finite gradient
                new_p = [torch.where(found_inf, p, n)
                         for p, n in zip(old, new_p)]
                new_s = [{k: torch.where(found_inf, s[k], v)
                          for k, v in ns.items()}
                         for s, ns in zip(self._opt_state, new_s)]
                self._scaler_state = self._next_scaler_state(st, found_inf,
                                                             step)
            torch._foreach_copy_(old, new_p)
            self._after_update(old)
        self._opt_state = new_s
        return self._reduce_loss(loss)

    def eval_step(self, *batch):
        """Forward only, nothing updated: ``(loss, outputs)`` of the
        model in the mode it is in (paddle_tpu's compiled
        ``eval_step``)."""
        if len(batch) < self.n_inputs:
            raise ValueError(f"TrainStep expects at least {self.n_inputs} "
                             "input(s)")
        batch = self._prepare_batch(batch)
        inputs, labels = batch[:self.n_inputs], batch[self.n_inputs:]
        with torch.no_grad(), self._amp_scope():
            out = self.model(*inputs)
            loss = self.loss_fn(out, *labels)
        return self._reduce_loss(loss), out

    # -- hooks of the distributed step (parallel.SpmdTrainStep) ----------
    def _prepare_batch(self, batch):
        return batch

    def _reduce_grads(self, grads):
        return grads

    def _update_targets(self):
        """The tensors the optimizer updates in place, one a parameter
        (the distributed step's ZeRO stages give a rank's rows)."""
        return [p.detach() for p in self._params]

    def _after_update(self, targets):
        pass

    def _reduce_loss(self, loss):
        return loss

    def _reduce_found_inf(self, found_inf):
        return found_inf
