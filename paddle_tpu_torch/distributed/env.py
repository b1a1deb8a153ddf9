"""Process-level distributed environment over ``torch.distributed``
(the counterpart of ``paddle_tpu/distributed/env.py``).

One process is one device: a rank drives one CUDA card (NCCL) or, when
the caller asks for the CPU, one CPU process (gloo).  Everything else
comes from the environment, as :func:`.launch.spawn` or a launcher sets
it: ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (default 0 / 1 /
``RANK``) and the rendezvous, ``DIST_INIT_METHOD`` (a ``file://`` store
or ``tcp://host:port``), else ``MASTER_ADDR`` / ``MASTER_PORT``
(``env://``), else, for a world of one, an in-process store.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv", "local_rank", "early_init"]

_TIMEOUT = datetime.timedelta(seconds=300)


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def local_rank() -> int:
    return _env_int("LOCAL_RANK", _env_int("RANK", 0))


def early_init():
    """paddle_tpu runs the ``jax.distributed`` rendezvous here, before
    anything initialises the XLA backend.  ``torch.distributed`` has no
    such ordering constraint: importing torch or this package touches no
    process group, and :func:`init_parallel_env` joins it whenever it is
    called.  So this is the no-op paddle_tpu's is when no launcher is
    present."""
    return None


def init_parallel_env(mesh_shape=None, *, device=None, backend=None):
    """``paddle.distributed.init_parallel_env`` parity: join the process
    group (once) and install the mesh (``mesh_shape``, default all ranks
    on ``dp``); returns the mesh.

    ``device`` defaults to the card (``cuda:<LOCAL_RANK>``, NCCL);
    ``device="cpu"`` takes gloo.  ``backend`` overrides the choice (e.g.
    ``"cpu:gloo,cuda:nccl"`` for one group over both)."""
    from .mesh import get_mesh, init_mesh
    if not dist.is_initialized():
        dev = torch.device(device) if device is not None else None
        if dev is None or dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init_parallel_env: no CUDA device is available; pass "
                    "device='cpu' to run the ranks on the CPU (gloo)")
            idx = dev.index if dev is not None and dev.index is not None \
                else local_rank() % torch.cuda.device_count()
            dev = torch.device("cuda", idx)
            torch.cuda.set_device(dev)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        world_size = _env_int("WORLD_SIZE", 1)
        init_method = os.environ.get("DIST_INIT_METHOD")
        if init_method is None and "MASTER_ADDR" in os.environ:
            init_method = "env://"
        kw = dict(backend=backend, rank=_env_int("RANK", 0),
                  world_size=world_size, timeout=_TIMEOUT)
        if init_method is None:
            if world_size != 1:
                raise RuntimeError(
                    f"init_parallel_env: world size {world_size} needs a "
                    f"rendezvous: set DIST_INIT_METHOD or "
                    f"MASTER_ADDR/MASTER_PORT")
            kw["store"] = dist.HashStore()
        else:
            kw["init_method"] = init_method
        dist.init_process_group(**kw)
    cur = get_mesh()
    if cur is not None and (mesh_shape is None
                            or dict(cur.shape) == dict(mesh_shape)):
        return cur
    return init_mesh(mesh_shape)


def is_initialized() -> bool:
    return dist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank: in the world, or inside ``group`` (a
    :class:`~.collective.Group` or a mesh axis name)."""
    if not dist.is_initialized():
        return 0
    if group is None:
        return dist.get_rank()
    from .collective import _resolve
    return _resolve(group).rank


def get_world_size(group=None) -> int:
    if not dist.is_initialized():
        return 1
    if group is None:
        return dist.get_world_size()
    from .collective import _resolve
    return _resolve(group).nranks


class ParallelEnv:
    """reference: fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def local_rank(self):
        return local_rank()

    @property
    def device_id(self):
        return local_rank()

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []
