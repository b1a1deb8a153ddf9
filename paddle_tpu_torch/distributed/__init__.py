"""paddle_tpu_torch.distributed: the process group, the mesh, the
collective API and the launcher, over ``torch.distributed`` (NCCL on the
card, gloo on the CPU).  One process drives one device."""
from . import collective, env, grad_comm, launch, mesh, strategy  # noqa: F401
from .collective import (Group, ReduceOp, all_gather,  # noqa: F401
                         all_reduce, alltoall, barrier, broadcast,
                         collective_permute, get_group, new_group, recv,
                         reduce, reduce_scatter, scatter, send, shift, spmd)
from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env, is_initialized)
from .launch import spawn  # noqa: F401
from .mesh import (DP_AXIS, MP_AXIS, PP_AXIS, SP_AXIS,  # noqa: F401
                   axis_index, axis_size, ensure_mesh, get_mesh, init_mesh,
                   set_mesh)
from .strategy import DistributedStrategy, validate_toggles  # noqa: F401
