"""The device mesh over the ranks of a ``torch.distributed`` job (the
counterpart of ``paddle_tpu/distributed/mesh.py``).

A mesh names axes of the rank grid: 'dp' (data), 'mp' (tensor/model),
'pp' (pipeline), 'sp' (sequence/context).  Ranks fill the grid in
row-major order, as JAX fills its device array: with ``{"dp": 2, "mp":
2}`` ranks 0 and 1 share dp index 0 and differ in mp.  Each axis is a set
of process subgroups, one per line of the grid along that axis; a rank's
collectives over an axis run in the line that holds it.

``torch.distributed.new_group`` must be called by every rank, for every
group, in the same order (also for the groups a rank is not in), so
:func:`init_mesh` creates all of them, axis by axis and line by line.
An axis of size 1 has no group: collectives over it are the identity.
"""
from __future__ import annotations

import threading
import warnings
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

__all__ = ["DP_AXIS", "MP_AXIS", "PP_AXIS", "SP_AXIS", "Mesh", "init_mesh",
           "get_mesh", "set_mesh", "ensure_mesh", "axis_size",
           "axis_index", "PartitionSpec", "NamedSharding", "named_sharding",
           "register_mesh_user", "release_mesh_user", "mesh_users"]

DP_AXIS = "dp"
MP_AXIS = "mp"
PP_AXIS = "pp"
SP_AXIS = "sp"

_lock = threading.RLock()
_global_mesh: Optional["Mesh"] = None
# live holders of shardings against a mesh: id(owner) -> (weakref(owner),
# mesh, note); an entry dies with its owner
_mesh_users: Dict[int, tuple] = {}


class PartitionSpec(tuple):
    """Which mesh axes split each tensor dim (``jax.sharding.
    PartitionSpec``'s shape): one entry a dim, None (whole), an axis
    name, or a tuple of names; trailing dims not named are whole."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


def _spec_entry_axes(entry) -> List[str]:
    if entry is None:
        return []
    return [entry] if isinstance(entry, str) else list(entry)


class NamedSharding:
    """A spec over a mesh.  In this port every rank holds its own block
    of a sharded tensor: :meth:`index` names the block of ``rank`` as
    slices of the global shape (a dim split over several axes counts in
    the entry's axis order, the last fastest, as GSPMD does)."""

    def __init__(self, mesh: "Mesh", spec=None):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else (
            PartitionSpec() if spec is None else PartitionSpec(*spec))

    def index(self, shape, rank: Optional[int] = None) -> tuple:
        coords = (self.mesh.coords if rank is None
                  else self.mesh.coords_of(rank))
        out = []
        for d, dim in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            n, k = 1, 0
            for a in _spec_entry_axes(entry):
                size = self.mesh.shape.get(a, 1)
                k = k * size + coords.get(a, 0)
                n *= size
            step = int(dim) // n
            out.append(slice(k * step, (k + 1) * step))
        return tuple(out)

    def shard_shape(self, shape) -> tuple:
        return tuple(sl.stop - sl.start for sl in self.index(shape))

    def __repr__(self):
        return f"NamedSharding(mesh={self.mesh.shape}, spec={self.spec})"


class Mesh:
    """Axis names, sizes, the rank grid, and this rank's subgroups.

    ``shape`` maps axis -> size in axis order; ``ranks`` is the grid;
    ``coords[axis]`` is this rank's index along ``axis``;
    ``line(axis)`` lists the global ranks of this rank's line along
    ``axis`` in index order; ``group(axis)`` is its process group (None
    for an axis of size 1)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        n = int(np.prod(list(shape.values()))) if shape else 1
        self.size = n
        self.ranks = np.arange(n).reshape(tuple(shape.values()) or ())
        self.rank = rank
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} lies outside the mesh {shape}")
        self.coords = dict(zip(self.axis_names, (int(i) for i in where[0])))
        self._lines: Dict[str, List[int]] = {}
        self._groups: Dict[str, object] = {}
        for ax_i, ax in enumerate(self.axis_names):
            moved = np.moveaxis(self.ranks, ax_i, -1).reshape(
                -1, self.shape[ax])
            for line in moved:
                line = [int(r) for r in line]
                if self.shape[ax] > 1:
                    # every rank creates every group, in the same order
                    pg = dist.new_group(line)
                    if rank in line:
                        self._groups[ax] = pg
                if rank in line:
                    self._lines[ax] = line

    def coords_of(self, rank: int) -> Dict[str, int]:
        where = np.argwhere(self.ranks == rank)[0]
        return dict(zip(self.axis_names, (int(i) for i in where)))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def line(self, axis: str) -> List[int]:
        return self._lines.get(axis, [self.rank])

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def init_mesh(shape: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """Create and install the global mesh.  ``shape`` maps axis -> size
    (default: every rank on 'dp'); the sizes multiply to the world size.
    Without a process group only a mesh of one rank exists.  ``devices``
    is accepted for parity: one process is one device here."""
    global _global_mesh
    del devices
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = {DP_AXIS: world}
    n = int(np.prod(list(shape.values()))) if shape else 1
    if n != world:
        raise ValueError(
            f"mesh shape {dict(shape)} holds {n} ranks but the job has "
            f"{world}: the sizes must multiply to the world size (start "
            f"the ranks with init_parallel_env / launch.spawn first)")
    with _lock:
        old = _global_mesh
        if old is not None and old.shape == dict(shape) \
                and old.rank == rank:
            return old          # the same grid: keep its groups
        _check_replace(dict(shape))
        mesh = Mesh(dict(shape), rank)
        _global_mesh = mesh
    return mesh


def register_mesh_user(owner, mesh: Mesh, note: str = "") -> None:
    """Record that ``owner`` (a built step, a sharded state) holds
    shardings built against ``mesh``: replacing that mesh while the
    owner lives raises (warns under ``FLAGS_mesh_replace_warn_only``)."""
    key = id(owner)

    def _drop(_ref, _key=key):
        _mesh_users.pop(_key, None)

    with _lock:
        _mesh_users[key] = (weakref.ref(owner, _drop), mesh, note)


def release_mesh_user(owner) -> None:
    with _lock:
        _mesh_users.pop(id(owner), None)


def mesh_users(mesh: Optional[Mesh] = None) -> List[str]:
    """Notes of the live owners holding shardings against ``mesh``
    (default: any mesh)."""
    out = []
    with _lock:
        for key, (ref, m, note) in list(_mesh_users.items()):
            if ref() is None:
                _mesh_users.pop(key, None)
            elif mesh is None or m is mesh:
                out.append(note or f"owner#{key}")
    return out


def _check_replace(new_shape: Dict[str, int]) -> None:
    old = _global_mesh
    if old is None or old.shape == new_shape:
        return
    users = mesh_users(old)
    if not users:
        return
    from ..core.enforce import PreconditionNotMetError
    from ..core.flags import get_flag
    msg = (f"replacing live mesh {dict(old.shape)} with {new_shape} while "
           f"{len(users)} built program(s) still hold shardings against "
           f"it: {users[:4]} — they would silently keep the old "
           f"placement.  Close the Executor / drop the train step first "
           f"(or set FLAGS_mesh_replace_warn_only=1 to proceed at your "
           f"own risk).")
    if get_flag("mesh_replace_warn_only"):
        warnings.warn(msg)
    else:
        raise PreconditionNotMetError(msg)


def named_sharding(*spec) -> NamedSharding:
    """A :class:`NamedSharding` over the global mesh."""
    return NamedSharding(ensure_mesh(), PartitionSpec(*spec))


def get_mesh() -> Optional[Mesh]:
    return _global_mesh


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    with _lock:
        _global_mesh = mesh


def ensure_mesh() -> Mesh:
    return _global_mesh if _global_mesh is not None else init_mesh()


def axis_size(name: str) -> int:
    m = get_mesh()
    return 1 if m is None else m.axis_size(name)


def axis_index(name: str) -> int:
    """This rank's index along ``name`` (0 without a mesh): the
    counterpart of ``jax.lax.axis_index``."""
    m = get_mesh()
    return 0 if m is None else m.axis_index(name)

