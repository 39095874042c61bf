"""Rank meshes over ``torch.distributed`` (counterpart of
``pose_splatter_tpu/parallel/mesh.py``).

A :class:`Mesh` arranges the ranks of the process group in a grid with
named axes, as ``jax.sharding.Mesh`` arranges devices:

- ``data``: frame batches (data parallel);
- ``tile`` (optional second axis): pixel tiles of each frame's render
  (``parallel/tile_sharding.py``).

One rank drives one device. The mesh holds one process group for each
axis line (the ranks that share every other coordinate); the collectives
of ``parallel/comm.py`` run over the line of this rank. Without an
initialised process group the mesh has one rank, every collective on it is
the identity, and the axis names stay, so that the same code path runs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, or (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Ranks reshaped to ``axis_shapes`` with names ``axis_names``.

    ``devices`` is the array of ranks (JAX's device array); ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape``; ``coords``
    is this rank's coordinate on each axis (None on a rank outside the
    mesh). Building a mesh over an initialised group is collective: every
    rank of the group must build the same mesh, in the same order as the
    others, because each axis line's group comes from ``dist.new_group``,
    which every rank enters, members or not.
    """

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim} axes, names {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        rank = world()[0]
        hit = np.argwhere(self.devices == rank)
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(self.axis_names, (int(c) for c in hit[0])))
            if len(hit) else None)
        self._groups: Dict[str, object] = {}
        if not (dist.is_available() and dist.is_initialized()):
            return
        members = [int(r) for r in self.devices.reshape(-1)]
        whole = dist.new_group(members)
        if rank in members:
            self._groups[None] = whole
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, i, -1).reshape(
                -1, self.devices.shape[i])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    self._groups[name] = group

    def group(self, axis: Optional[str]):
        """This rank's process group along ``axis`` (None: the whole
        mesh); None without an initialised process group (the collectives
        are then the identity)."""
        if axis is not None and axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r} ({self.axis_names})")
        return self._groups.get(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        if self.coords is None:
            raise RuntimeError("this rank is not in the mesh")
        return self.coords[axis]


def make_mesh(axis_shapes: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data",),
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the ranks ``devices`` (default every rank of the group).

    ``make_mesh()`` → 1D ``data`` mesh over all ranks.
    ``make_mesh((2, 2), ("data", "tile"))`` → 2D mesh.
    """
    if devices is None:
        devices = list(range(world()[1]))
    n = len(devices)
    if axis_shapes is None:
        axis_shapes = (n,)
    if int(np.prod(axis_shapes)) != n:
        raise ValueError(f"mesh {tuple(axis_shapes)} needs "
                         f"{int(np.prod(axis_shapes))} ranks, have {n}")
    return Mesh(np.asarray(devices).reshape(axis_shapes), axis_names)
