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
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

__all__ = ["DP_AXIS", "MP_AXIS", "PP_AXIS", "SP_AXIS", "Mesh", "init_mesh",
           "get_mesh", "set_mesh", "ensure_mesh", "axis_size",
           "axis_index"]

DP_AXIS = "dp"
MP_AXIS = "mp"
PP_AXIS = "pp"
SP_AXIS = "sp"

_lock = threading.Lock()
_global_mesh: Optional["Mesh"] = None


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
    mesh = Mesh(dict(shape), rank)
    with _lock:
        _global_mesh = mesh
    return mesh


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

