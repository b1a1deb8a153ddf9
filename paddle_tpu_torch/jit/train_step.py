"""TrainStep (paddle_tpu.jit.train_step): one call runs forward,
backward, gradient clip and optimizer update.

PyTorch runs it eagerly, kernel by kernel; there is no compiled
program.  The parameters and optimizer slots are updated in place
after the optimizer's pure ``functional_update``, which stands in for
the JAX step's donated buffers: ``donate`` is accepted and has no
effect.  Dropout draws anew at every call (``F.dropout`` from the
device generator, flash attention from ``core.rng.next_seed``), so two
steps never share a mask.

Not ported yet (ROADMAP A3): ``scaler`` (dynamic loss scaling),
``accumulate_steps > 1``, ``recompute`` and ``amp_level`` (auto_cast
O1); each raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

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
        if scaler is not None:
            raise NotImplementedError("TrainStep: scaler (GradScaler) is "
                                      "not ported yet")
        if int(accumulate_steps) != 1:
            raise NotImplementedError("TrainStep: accumulate_steps > 1 is "
                                      "not ported yet")
        if recompute:
            raise NotImplementedError("TrainStep: recompute is not ported "
                                      "yet")
        if amp_level is not None:
            raise NotImplementedError("TrainStep: amp_level (auto_cast) is "
                                      "not ported yet")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_inputs = n_inputs
        self.donate = donate
        self._params = [p for _, p in model.named_parameters()]
        self._opt_state = None

    def __call__(self, *batch):
        if len(batch) < self.n_inputs:
            raise ValueError(f"TrainStep expects at least {self.n_inputs} "
                             "input(s)")
        batch = self._prepare_batch(batch)
        inputs, labels = batch[:self.n_inputs], batch[self.n_inputs:]
        params = self._params
        if self._opt_state is None:
            self._opt_state = self.optimizer.functional_init(
                [p.detach() for p in params])
        loss = self.loss_fn(self.model(*inputs), *labels)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = self._reduce_grads([torch.zeros_like(p) if g is None else g
                                    for p, g in zip(params, grads)])
        self.optimizer._step_count += 1
        with torch.no_grad():
            new_p, self._opt_state = self.optimizer.functional_update(
                [p.detach() for p in params], grads, self._opt_state,
                self.optimizer.get_lr(), self.optimizer._step_count,
                params_meta=params)
            torch._foreach_copy_([p.detach() for p in params], new_p)
        return self._reduce_loss(loss.detach())

    # -- hooks of the distributed step (parallel.SpmdTrainStep) ----------
    def _prepare_batch(self, batch):
        return batch

    def _reduce_grads(self, grads):
        return grads

    def _reduce_loss(self, loss):
        return loss
