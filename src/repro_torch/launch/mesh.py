"""Named device meshes: axis names and sizes, and their ``DeviceMesh``.

The reference builds ``jax.make_mesh`` meshes.  A :class:`Mesh` here is
what the sharding rules read (``.shape`` and ``.axis_names``, as the
reference's tests' ``FakeMesh``); :func:`device_mesh` turns it into a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group (ranks laid out row-major, the first axis outermost, as
``jax.make_mesh`` lays out devices), on which the partitioned program runs
(``models/layers.py``'s ``Ctx``).  :func:`named` reads a ``DeviceMesh``
back as a :class:`Mesh`.  The dry-run lowers every cell on the
reference's production meshes and sizes it on the one card
(:data:`MESHES`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Mesh axes ``axis_names`` of sizes ``sizes`` (same order)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh() -> Mesh:
    """1-device mesh with the production axis names: the one card."""
    return Mesh(("data", "model"), (1, 1))


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``mesh``'s shape and axis names over ranks
    ``0 .. n_devices - 1`` of the default process group, which must be
    initialised with exactly that many ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if dist.get_world_size() != mesh.n_devices:
        raise ValueError(f"a {mesh.sizes} mesh needs {mesh.n_devices} "
                         f"ranks; the group has {dist.get_world_size()}")
    ranks = torch.arange(mesh.n_devices).reshape(mesh.sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)


def named(mesh):
    """``mesh`` as the sharding rules read it (``.axis_names`` and a
    ``.shape`` dict): a :class:`Mesh` or anything else that has them as it
    is, a ``DeviceMesh`` with axis names as a :class:`Mesh`."""
    if hasattr(mesh, "axis_names"):
        return mesh
    return Mesh(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


#: mesh name -> mesh, the names the dry-run's records carry
MESHES = {"pod16x16": make_production_mesh(),
          "pod2x16x16": make_production_mesh(multi_pod=True),
          "h100x1": make_local_mesh()}
