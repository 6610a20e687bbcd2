"""Named device meshes for the dry-run: axis names and sizes, no devices.

The reference builds ``jax.make_mesh`` meshes; on one card no program is
partitioned, so a mesh here is only what the sharding rules read
(``.shape`` and ``.axis_names``, as the reference's tests' ``FakeMesh``).
The dry-run sizes every cell on the reference's production meshes and on
the one card (:data:`MESHES`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


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


#: mesh name -> mesh, the names the dry-run's records carry
MESHES = {"pod16x16": make_production_mesh(),
          "pod2x16x16": make_production_mesh(multi_pod=True),
          "h100x1": make_local_mesh()}
