"""paddle_tpu_torch.distributed: the process group, the mesh, the
collective API, the launcher, fleet, the sharding plans (ZeRO 1-3) and
the gradient-communication stage, over ``torch.distributed`` (NCCL on
the card, gloo on the CPU).  One process drives one device."""
from . import collective, env, grad_comm, launch, mesh, strategy  # noqa: F401
from . import fleet as _fleet_mod  # noqa: F401
from . import sharding  # noqa: F401
from .collective import (Group, ReduceOp, all_gather,  # noqa: F401
                         all_gather_object, all_reduce, alltoall, barrier,
                         broadcast, collective_permute, get_group, in_spmd,
                         new_group, recv, reduce, reduce_scatter, scatter,
                         send, shift, spmd)
from .env import (ParallelEnv, early_init, get_rank,  # noqa: F401
                  get_world_size, init_parallel_env, is_initialized)
from .fleet import Fleet, fleet  # noqa: F401
from .launch import spawn  # noqa: F401
from .mesh import (DP_AXIS, MP_AXIS, PP_AXIS, SP_AXIS,  # noqa: F401
                   axis_index, axis_size, ensure_mesh, get_mesh, init_mesh,
                   mesh_users, named_sharding, register_mesh_user,
                   release_mesh_user, set_mesh)
from .sharding import (ShardedState, ShardingPlan,  # noqa: F401
                       SpecLayout, gather_tree, match_partition_rules,
                       plan_for_params, shard_tree, spec_divisor,
                       specs_for_state, with_constraint)
from .strategy import DistributedStrategy, validate_toggles  # noqa: F401


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """paddle.distributed.split parity (reference: collective.py:809):
    the tensor-parallel embedding or linear over 'mp'."""
    from ..parallel.tp_layers import split as _split
    return _split(x, size, operation, axis, num_partitions, gather_out,
                  weight_attr, bias_attr, name)
