"""Device meshes for the port (the mesh part of
``repro.distributed.sharding``).

A ``Mesh`` is an array of ``torch.device`` with named axes. The routing
mesh (``core.mesh_router``) routes its cell blocks on the devices of the
mesh's leading axis itself, so there is no ``shard_map`` counterpart.
The training placements (parameter, batch and cache specs) come with the
training mesh (ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Mesh(NamedTuple):
    """``devices``: an object array of ``torch.device`` shaped like the
    axes; ``axis_names``: one name per axis."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(axis_shapes, axis_names, *, devices=None) -> Mesh:
    """A mesh over ``devices`` (``None``: every CUDA device).

    The axis shapes must account for every device the mesh draws from:
    a mesh never covers a SUBSET of them in silence. To undersubscribe,
    pass the subset explicitly. Devices of different types in one mesh
    raise."""
    axis_shapes = tuple(int(s) for s in axis_shapes)
    axis_names = tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis shapes for "
                         f"{len(axis_names)} axis names")
    want = int(np.prod(axis_shapes, dtype=np.int64))
    if devices is None:
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        source = "the platform exposes"
    else:
        avail = [torch.device(d) for d in devices]
        source = "the devices argument supplies"
    if want != len(avail):
        raise ValueError(
            f"mesh axis shapes {axis_shapes} require {want} device(s) "
            f"but {source} {len(avail)}; pass an explicit subset "
            "(devices=[torch.device('cuda', i) for i in range(n)]) to "
            "build a smaller mesh"
        )
    kinds = sorted({d.type for d in avail})
    if len(kinds) > 1:
        raise ValueError(f"a mesh holds one device type, got {kinds}")
    grid = np.empty(len(avail), dtype=object)
    grid[:] = avail
    return Mesh(devices=grid.reshape(axis_shapes), axis_names=axis_names)
