"""SpmdTrainStep: the multi-device training step (the counterpart of
``paddle_tpu/parallel/spmd_train_step.py``).

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

The strategy's ``gradient_merge`` (``k_steps`` micro-batches a step),
``recompute`` (the loss's forward as one recomputed segment) and ``amp``
(``auto_cast`` at O1, or O2 under ``use_pure_fp16``, in
``amp_configs.dtype``; float16 with a ``GradScaler`` from the configs)
are ``jit.TrainStep``'s own, as the JAX step wires them.

A parameter whose placement cuts it over 'dp' (``ShardedEmbedding``)
holds its own rows, and its lookup's backward already sums every rank's
cotangents into them: its gradient is divided by the dp size, not
averaged over ranks.

Optimizer, O2 master weights and the global-norm clip are the port's
own (``jit.TrainStep``); the clip sums the squares of mp-sharded
gradients over 'mp' (:mod:`..optimizer.clip`), not each rank's share.

ZeRO (``strategy.sharding``, at dp > 1), on every parameter without a
tensor-parallel placement whose dim 0 the dp size divides (stage 3:
every one of at least ``min_shard_numel`` elements, dim 0 padded with
zero rows to a multiple of dp where it does not divide, as paddle_tpu
pads; ``_padded`` holds ``(d0, padded d0)``):

- stages 1 and 2: its optimizer slots hold only this rank's dim-0
  rows, the gradient is reduce-scattered to those rows (paddle_tpu's
  stage 1 averages the whole gradient and keeps the rows: the same
  values), the update writes them, and an all-gather of the updated
  rows gives every rank the full parameter again;
- stage 3: the parameter rests as this rank's rows between steps
  (:class:`~..distributed.sharding.ParamShards`): each step all-gathers
  them just before the forward, and the update writes the rows.
  :meth:`SpmdTrainStep.sync_params` gives the model its full values
  again (``Layer.state_dict`` calls it), as paddle_tpu writes its
  shards back there.

Every sum over ranks here runs in ascending member order
(``distributed.grad_comm``), so ZeRO's numerics are the replicated
step's: a reduce-scatter (all-to-all and an ascending sum of the
chunks), with an all-gather after it for a replicated gradient of at
least 32 KB, or one gather of every rank's copy below that.
``strategy.grad_comm`` (or its bf16 alias ``fp16_allreduce``)
reduces the gradients through the bucketed, quantized stage of
:mod:`..distributed.grad_comm` instead, without error feedback (its
residual carry lives on the static Executor's path), and refuses
ZeRO-3 and model-parallel axes with paddle_tpu's messages.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import rng
from ..distributed.collective import ReduceOp, all_reduce, axis_group
from ..distributed.mesh import DP_AXIS, PartitionSpec, ensure_mesh
from ..distributed.strategy import DistributedStrategy, validate_toggles
from ..jit.train_step import TrainStep
from ..nn.functional.norm import stats_over
from .data_parallel import allreduce_gradients
from .tp_layers import get_placement


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _shardable(shape, n):
    return len(shape) > 0 and shape[0] % n == 0 and shape[0] >= n

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
        if accumulate_steps is None:
            accumulate_steps = (strategy.gradient_merge_configs.k_steps
                                if strategy.gradient_merge else 1)
        amp_level = None
        if strategy.amp:
            c = strategy.amp_configs
            if scaler is None and c.dtype == "float16":
                from ..amp import GradScaler
                scaler = GradScaler(
                    init_loss_scaling=c.init_loss_scaling,
                    incr_ratio=c.incr_ratio, decr_ratio=c.decr_ratio,
                    incr_every_n_steps=c.incr_every_n_steps,
                    decr_every_n_nan_or_inf=c.decr_every_n_nan_or_inf,
                    use_dynamic_loss_scaling=c.use_dynamic_loss_scaling)
            amp_level = "O2" if c.use_pure_fp16 else "O1"
            model._amp_dtype = c.dtype
        super().__init__(model, loss_fn, optimizer, n_inputs, donate,
                         scaler=scaler, accumulate_steps=accumulate_steps,
                         recompute=strategy.recompute, amp_level=amp_level)
        self.mesh = mesh or ensure_mesh()
        self.strategy = strategy
        self.dp = axis_group(DP_AXIS, self.mesh)
        from ..distributed import grad_comm as _gc
        self._grad_comm = _gc.resolve(strategy)
        self._comm_plan = None
        if self._grad_comm is not None:
            zero3 = strategy.sharding and strategy.sharding_configs.stage >= 3
            msg = _gc.incompatibility(
                self._grad_comm, self.mesh.shape,
                sharded_params=(["<ZeRO-3 stage-3 params>"] if zero3
                                else ()))
            if msg is not None:
                raise NotImplementedError(msg)
            if (self._grad_comm.error_feedback
                    and self._grad_comm.source == "grad_comm"
                    and self._grad_comm.dtype != "fp32"):
                import warnings
                warnings.warn(
                    "grad_comm.error_feedback: the per-rank residual "
                    "carry lives in the static Executor's state; "
                    "SpmdTrainStep reduces without error feedback.  Use "
                    "the static path (fleet + Executor) for EF, or set "
                    "error_feedback=False to silence this.")
        # -- ZeRO-3 padding plan (paddle_tpu pads dim 0 to a dp multiple)
        # and the sharding rules, fixed at construction from the full
        # shapes (a ZeRO-3 param's own shape is its rows' between steps)
        self._shapes = [tuple(p.shape) for p in self._params]
        self._padded = {}
        z3 = []
        n = self.dp.nranks
        if self._stage() >= 3:
            min_numel = strategy.sharding_configs.min_shard_numel
            for i, p in enumerate(self._params):
                shp = self._shapes[i]
                if (get_placement(p) is not None or len(shp) == 0
                        or _numel(shp) < min_numel):
                    continue
                if shp[0] % n != 0:
                    self._padded[i] = (shp[0], -(-shp[0] // n) * n)
                if i in self._padded or _shardable(shp, n):
                    z3.append(i)
        self._z3 = tuple(z3)
        # the ZeRO-3 params resting as this rank's rows between steps
        from ..distributed.sharding import ParamShards
        self._shards = ParamShards()

    # -- sharding rules ----------------------------------------------------
    def _dp_size(self) -> int:
        return self.mesh.shape.get(DP_AXIS, 1)

    def _stage(self) -> int:
        return (int(self.strategy.sharding_configs.stage)
                if self.strategy.sharding and DP_AXIS in self.mesh.shape
                else 0)

    def _stage3_sharded(self, i, p) -> bool:
        return i in self._z3

    def _param_spec(self, i, p) -> PartitionSpec:
        pl = get_placement(p)
        if pl is not None:
            return PartitionSpec(*pl)
        if self._stage3_sharded(i, p):
            return PartitionSpec(DP_AXIS)
        return PartitionSpec()

    def _stored_shape(self, i, p):
        if i in self._padded:
            return (self._padded[i][1],) + self._shapes[i][1:]
        return self._shapes[i]

    def _slot_spec(self, i, p, slot_shape) -> PartitionSpec:
        pl = get_placement(p)
        if pl is not None and tuple(slot_shape) == self._shapes[i]:
            return PartitionSpec(*pl)
        if (self._stage() >= 1 and tuple(slot_shape) == self._stored_shape(
                i, p) and _shardable(slot_shape, self._dp_size())):
            return PartitionSpec(DP_AXIS)
        return PartitionSpec()

    def _zero_rows(self):
        """Positions of the params whose rows this rank updates (ZeRO at
        dp > 1)."""
        if self._stage() < 1 or self.dp.nranks <= 1:
            return ()
        n = self.dp.nranks
        return tuple(i for i, p in enumerate(self._params)
                     if get_placement(p) is None
                     and (i in self._padded
                          or _shardable(self._shapes[i], n)))

    def _resting(self):
        """The params that rest as this rank's rows (ZeRO-3 at dp > 1)."""
        if self.dp.nranks <= 1:
            return []
        return [self._params[i] for i in self._z3]

    def _padded_full(self, i, t):
        if i in self._padded:
            d0, pd0 = self._padded[i]
            t = torch.nn.functional.pad(
                t, [0, 0] * (t.dim() - 1) + [0, pd0 - d0])
        return t

    def _rows(self, t):
        n, r = self.dp.nranks, self.dp.rank
        per = t.shape[0] // n
        return t[r * per:(r + 1) * per]

    # -- the update on this rank's rows ------------------------------------
    def _update_targets(self):
        rows = set(self._zero_rows())
        z3 = set(self._z3) if self.dp.nranks > 1 else set()
        out = []
        for i, p in enumerate(self._params):
            if i in z3:
                pad = self._padded.get(i)
                t = self._shards.rows(p, self.dp,
                                      None if pad is None else pad[1])
            elif i in rows:
                t = self._rows(p.detach())
            else:
                t = p.detach()
            out.append(t)
        return out

    def _after_update(self, targets):
        rows = [i for i in self._zero_rows() if i not in self._z3]
        import torch.distributed as dist
        # ZeRO 1-2: every rank's updated rows make the full param again
        for i in rows:
            dist.all_gather(list(self._params[i].detach().chunk(
                self.dp.nranks)), targets[i].clone(),
                group=self.dp.process_group)
        # ZeRO-3: the param rests as the rows the update wrote
        self._shards.release(self._resting())

    @property
    def _p_store(self):
        """This rank's stored rows of each resting ZeRO-3 param."""
        return {i: self._shards.rows_of(self._params[i]) for i in self._z3
                if self._shards.rows_of(self._params[i]) is not None}

    def sync_params(self):
        """Give the model's ZeRO-3 params their full values again,
        gathered from every rank's rows (a collective: every rank calls
        it).  Between steps such a param holds only this rank's rows;
        ``Layer.state_dict`` and ``set_state_dict`` call this first.
        After it the params hold their full values, which the next step
        reads (so an outside load into them is kept)."""
        self._shards.sync()

    def eval_step(self, *batch):
        held = self._shards.materialize(self._resting())
        try:
            return super().eval_step(*batch)
        finally:
            self._shards.release(held)

    def __call__(self, *batch):
        if self.dp.nranks == 1:
            return super().__call__(*batch)
        # ZeRO-3 params are gathered from the ranks' rows just before
        # the forward, and rest as the updated rows after the step
        held = self._shards.materialize(self._resting())
        try:
            with rng.fold_in(self.dp.rank), stats_over(self.dp):
                return super().__call__(*batch)
        finally:
            self._shards.release(held)

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
        from ..distributed import grad_comm as _gc
        n = self.dp.nranks
        if n == 1:
            return grads
        rows = set(self._zero_rows())
        if self._grad_comm is not None:
            if self._comm_plan is None:
                shapes = [self._stored_shape(i, p)
                          for i, p in enumerate(self._params)]
                self._comm_plan = _gc.plan_reduction(shapes, dp=n,
                                                     cfg=self._grad_comm)
            padded = [self._padded_full(i, g) for i, g in enumerate(grads)]
            red, _ = _gc.reduce_gradients(padded, plan=self._comm_plan,
                                          group=self.dp)
            return [self._rows(g) if i in rows else g
                    for i, g in enumerate(red)]
        # a parameter whose rows are cut over 'dp' (ShardedEmbedding)
        # holds the sum of every rank's gradient for its own rows already
        split = {i for i, p in enumerate(self._params)
                 if DP_AXIS in (get_placement(p) or ())}
        if not rows and not split:
            return allreduce_gradients(grads, self.dp)
        out = []
        for i, g in enumerate(grads):
            if i in split:
                out.append(g / n)
                continue
            if i not in rows:
                out.append(_gc.sum_over(g, self.dp) / n)
                continue
            # reduce-scatter (every stage): this rank's rows of the sum
            g = self._padded_full(i, g)
            red = _gc._rs_only(g.reshape(-1), self.dp, n, False).reshape(
                (g.shape[0] // n,) + tuple(g.shape[1:]))
            out.append(red / n)
        return out

    def _reduce_loss(self, loss):
        return all_reduce(loss.clone(), ReduceOp.AVG, self.dp)

    def _reduce_found_inf(self, found_inf):
        # each mp/sp rank checks only its own shards: skip the step on
        # every rank of the job if any rank saw a non-finite gradient
        flag = found_inf.to(torch.int32)
        return all_reduce(flag, ReduceOp.MAX) > 0
