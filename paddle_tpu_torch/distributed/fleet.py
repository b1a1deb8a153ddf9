"""Fleet, the distributed-training facade (the counterpart of
``paddle_tpu/distributed/fleet.py``).

``init`` joins the process group (once) and installs the mesh the
strategy implies over the job's ranks, or keeps a mesh the caller
pinned when it carries the strategy's model-parallel degrees.
``distributed_optimizer`` validates the strategy, swaps in LAMB or LARS
when it asks, and marks the optimizer with the strategy: a static
Program it ``minimize``s then runs under a ``ShardingPlan`` in the
``Executor`` (ZeRO-3 params, the grad_comm stage).  ``get_train_step``
builds one ``SpmdTrainStep`` from the strategy.

The fleet dataset entry points (``DatasetFactory``, ``InMemoryDataset``,
``QueueDataset``) come with the data pipeline (slice A6).
"""
from __future__ import annotations

import os
from typing import Optional

from .env import ParallelEnv, get_rank, get_world_size, init_parallel_env
from .mesh import ensure_mesh, get_mesh, init_mesh
from .strategy import DistributedStrategy

__all__ = ["Fleet", "fleet", "DistributedStrategy", "ParallelEnv",
           "ensure_mesh", "get_mesh", "get_rank", "get_world_size",
           "init_mesh", "init_parallel_env"]


class _RoleMaker:
    """The collective role (reference: role_maker.py
    PaddleCloudRoleMaker)."""

    def __init__(self, is_collective=True):
        self.is_collective = is_collective

    def worker_num(self):
        return get_world_size()

    def worker_index(self):
        return get_rank()

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return get_rank() == 0


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _join(mesh_shape):
    """``init_parallel_env`` on the device ``set_device`` chose (the
    card by default)."""
    from ..core.placement import default
    return init_parallel_env(mesh_shape, device=default())


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._role_maker: Optional[_RoleMaker] = None
        self._optimizer = None
        self._user_optimizer = None
        self._model = None
        self._train_step = None

    # -- lifecycle ---------------------------------------------------------
    def init(self, role_maker=None, is_collective=True, strategy=None):
        self._role_maker = role_maker or _RoleMaker(is_collective)
        self._strategy = strategy or DistributedStrategy()
        cur = get_mesh()
        if cur is not None:
            # keep a pinned mesh that carries the strategy's
            # model-parallel degrees (re-deriving over every rank would
            # fight the caller's init_mesh)
            try:
                want = self._strategy.infer_mesh_shape(int(cur.size))
            except Exception:   # the degrees do not fit the pinned mesh
                want = None
            from .mesh import MP_AXIS, PP_AXIS, SP_AXIS
            cur_shape = dict(cur.shape)
            if want is not None and all(
                    cur_shape.get(a, 1) == want.get(a, 1)
                    for a in (MP_AXIS, PP_AXIS, SP_AXIS)):
                _join(cur_shape)
                return self
        _join(self._strategy.infer_mesh_shape(_world()))
        return self

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_num(self):
        return self._role_maker.worker_num()

    def worker_index(self):
        return self._role_maker.worker_index()

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def worker_endpoints(self, to_string=False):
        eps = ParallelEnv().trainer_endpoints
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        from .collective import barrier
        barrier()

    def init_worker(self):
        pass

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        raise NotImplementedError(
            "Parameter-server mode is not carried, as in paddle_tpu: the "
            "parameter-server capability is the mesh-sharded embedding "
            "table (parallel.ShardedEmbedding)")

    def stop_worker(self):
        pass

    # -- strategy ----------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        """Validate the strategy (toggles, degrees against the mesh),
        swap the optimizer for LAMB / LARS when the strategy asks, and
        mark it with the strategy for ``minimize`` and the Executor."""
        if strategy is not None:
            self._strategy = strategy
        self._user_optimizer = optimizer
        opt = optimizer
        s = self._strategy or DistributedStrategy()
        from .strategy import validate_toggles
        mesh = get_mesh()
        validate_toggles(s, n_devices=(int(mesh.size) if mesh is not None
                                       else _world()))
        if s.lamb:
            from ..optimizer import Lamb
            if not isinstance(opt, Lamb):
                opt = Lamb(learning_rate=opt._learning_rate,
                           lamb_weight_decay=s.lamb_configs.lamb_weight_decay,
                           parameters=opt._parameter_list,
                           grad_clip=opt._grad_clip)
        elif s.lars:
            from ..optimizer import LarsMomentum
            if not isinstance(opt, LarsMomentum):
                opt = LarsMomentum(
                    learning_rate=opt._learning_rate,
                    lars_coeff=s.lars_configs.lars_coeff,
                    lars_weight_decay=s.lars_configs.lars_weight_decay,
                    parameters=opt._parameter_list,
                    grad_clip=opt._grad_clip)
        # the static Executor reads the strategy off the optimizer of the
        # Program it runs and builds a ShardingPlan from it
        opt._dist_strategy = s
        self._optimizer = opt
        return opt

    def distributed_model(self, model):
        from ..parallel.data_parallel import DataParallel
        self._model = model
        return DataParallel(model)

    def get_train_step(self, model, loss_fn, optimizer=None, n_inputs=1):
        """The strategy as one ``SpmdTrainStep``; ``strategy.localsgd``
        / ``adaptive_localsgd`` route to the per-replica
        ``LocalSGDTrainStep`` instead."""
        opt = optimizer or self._optimizer
        s = self._strategy or DistributedStrategy()
        if s.localsgd or s.adaptive_localsgd:
            from ..parallel.localsgd import LocalSGDTrainStep
            step = LocalSGDTrainStep(model, loss_fn, opt, mesh=ensure_mesh(),
                                     strategy=s, n_inputs=n_inputs,
                                     adaptive=s.adaptive_localsgd)
        else:
            from ..parallel.spmd_train_step import SpmdTrainStep
            step = SpmdTrainStep(model, loss_fn, opt, mesh=ensure_mesh(),
                                 strategy=s, n_inputs=n_inputs, donate=True)
        self._train_step = step
        return step

    def _sync_step_params(self):
        """Write the step's authoritative weights back into the model
        before a persistence read (LocalSGD's replicas, ZeRO-3's
        shards)."""
        step = getattr(self, "_train_step", None)
        if step is not None:
            step.sync_params()

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        assert self._optimizer is not None, "call distributed_optimizer first"
        return self._optimizer.minimize(loss)

    # -- persistence -------------------------------------------------------
    def save_persistables(self, executor=None, dirname=None,
                          main_program=None, mode=0):
        """The registered model's ``model.pdparams`` in ``dirname``.
        Every rank of the job calls it: each gives its ZeRO-3 params
        their full values, world rank 0 writes the one file, and the
        ranks meet before any returns (so every rank may read it)."""
        from ..framework_io import save
        self._sync_step_params()
        if self._model is not None and dirname:
            state = self._model.state_dict()
            if get_rank() == 0:
                save(state, os.path.join(dirname, "model.pdparams"))
            if _world() > 1:
                from .collective import barrier
                barrier()

    def save_inference_model(self, executor=None, dirname=None,
                             feeded_var_names=None, target_vars=None,
                             main_program=None, export_for_deployment=True,
                             model=None, input_spec=None):
        """Export a servable artifact through ``jit.save``: pass
        ``model`` and ``input_spec``, or call ``distributed_model``
        first."""
        model = model or self._model
        if model is None:
            raise ValueError(
                "fleet.save_inference_model: no model registered — call "
                "fleet.distributed_model(model) first or pass model=...")
        self._sync_step_params()
        if dirname is None:
            raise ValueError("fleet.save_inference_model: dirname required")
        from .. import jit as pjit
        inner = getattr(model, "_layers", model)
        path = os.path.join(dirname, "model")
        pjit.save(inner, path, input_spec=input_spec)
        return path

    @property
    def util(self):
        return _FleetUtil()


class _FleetUtil:
    def all_reduce(self, input, mode="sum"):
        """``input`` reduced over every rank of the job, ``mode`` one of
        ``'sum'``, ``'max'`` and ``'min'``: a tensor comes back as a
        tensor on its device, anything else as a numpy array.  Every
        rank calls it.  (paddle_tpu returns its input: one controller
        holds every device there.  Here each rank is a process with its
        own value, so at world size 1 the input is the answer.)"""
        from .collective import ReduceOp, all_reduce
        ops = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
               "min": ReduceOp.MIN}
        if mode not in ops:
            raise ValueError(f"fleet.util.all_reduce: mode {mode!r}, "
                             f"expected one of {sorted(ops)}")
        if _world() == 1:
            return input
        import numpy as np
        import torch
        import torch.distributed as tdist
        is_t = isinstance(input, torch.Tensor)
        t = (input.detach() if is_t
             else torch.as_tensor(np.asarray(input)))
        dev = (torch.device("cuda", torch.cuda.current_device())
               if tdist.get_backend() == "nccl" else torch.device("cpu"))
        out = all_reduce(t.to(dev, copy=True), ops[mode])
        return out.to(input.device) if is_t else out.cpu().numpy()

    def barrier(self, comm_world="worker"):
        from .collective import barrier
        barrier()

    def get_file_shard(self, files):
        w = get_world_size()
        i = get_rank()
        return files[i::w]


fleet = Fleet()
