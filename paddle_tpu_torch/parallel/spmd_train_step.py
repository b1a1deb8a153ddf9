"""SpmdTrainStep: the multi-device training step (the counterpart of
``paddle_tpu/parallel/spmd_train_step.py``), without ZeRO, grad_comm or
padding.

Every rank runs the same step on the same global batch:

- the batch is cut along dim 0 over 'dp' and each rank keeps its slice;
- forward and backward run with the tensor-parallel layers and ring
  attention writing out their own collectives over 'mp' and 'sp';
- every gradient is averaged over 'dp' (:func:`.data_parallel.
  allreduce_gradients`), and so is the returned loss;
- with a ``scaler``, the overflow check reads the averaged gradients
  and its flag is reduced (any) over every rank of the job, so all
  ranks skip or apply a step together and keep one loss scale, as the
  JAX step's check over global arrays does;
- at dp > 1 every random draw of the step (dropout masks, the flash
  kernels' dropout seeds) comes from the 'dp' rank's own stream
  (``core.rng.fold_in``), as the JAX package folds ``axis_index('dp')``
  into its dropout key: each dp shard of the batch gets its own masks,
  deterministic per (seed, dp rank), while the 'mp' and 'sp' ranks of
  one dp group draw the same masks, as their replicated activations
  need;
- at dp > 1 every batch norm in training takes the statistics of the
  global batch (``nn.functional.norm.stats_over`` the 'dp' group), as
  GSPMD reduces the JAX package's over the sharded batch: each rank
  normalises with them, and its running buffers move by them, so every
  rank holds the same buffers.

Parameters replicated over 'mp' and 'sp' need no further reduction: the
computation that feeds them is replicated there too (each TP layer's
output is full on every mp rank, ring attention's on every sp rank), so
their gradients already agree.  The tests hold them equal across ranks.

Optimizer, O2 master weights and the global-norm clip are the port's
own (``jit.TrainStep``); the clip sums the squares of mp-sharded
gradients over 'mp' (:mod:`..optimizer.clip`), not each rank's share.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import rng
from ..distributed.collective import ReduceOp, all_reduce, axis_group
from ..distributed.mesh import DP_AXIS, ensure_mesh
from ..distributed.strategy import DistributedStrategy, validate_toggles
from ..jit.train_step import TrainStep
from ..nn.functional.norm import stats_over
from .data_parallel import allreduce_gradients

__all__ = ["SpmdTrainStep"]


class SpmdTrainStep(TrainStep):
    """TrainStep over the mesh.  ``strategy`` toggles that are not ported
    raise (``distributed.strategy.validate_toggles``)."""

    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 strategy: Optional[DistributedStrategy] = None,
                 n_inputs: int = 1, donate: bool = True, scaler=None,
                 accumulate_steps: Optional[int] = None):
        strategy = strategy or DistributedStrategy()
        validate_toggles(strategy)
        super().__init__(model, loss_fn, optimizer, n_inputs, donate,
                         scaler=scaler, accumulate_steps=accumulate_steps or 1)
        self.mesh = mesh or ensure_mesh()
        self.strategy = strategy
        self.dp = axis_group(DP_AXIS, self.mesh)

    def __call__(self, *batch):
        if self.dp.nranks == 1:
            return super().__call__(*batch)
        with rng.fold_in(self.dp.rank), stats_over(self.dp):
            return super().__call__(*batch)

    def _prepare_batch(self, batch):
        n, r = self.dp.nranks, self.dp.rank
        if n == 1:
            return batch
        out = []
        for t in batch:
            if t.shape[0] % n:
                raise ValueError(f"SpmdTrainStep: batch dim {t.shape[0]} is "
                                 f"not divisible by the 'dp' size {n}")
            per = t.shape[0] // n
            out.append(t[r * per:(r + 1) * per])
        return tuple(out)

    def _reduce_grads(self, grads):
        return allreduce_gradients(grads, self.dp)

    def _reduce_loss(self, loss):
        return all_reduce(loss.clone(), ReduceOp.AVG, self.dp)

    def _reduce_found_inf(self, found_inf):
        # each mp/sp rank checks only its own shards: skip the step on
        # every rank of the job if any rank saw a non-finite gradient
        flag = found_inf.to(torch.int32)
        return all_reduce(flag, ReduceOp.MAX) > 0
