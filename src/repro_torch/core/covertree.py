"""Cover-tree baseline (Beygelzimer et al., ICML'06) — paper's comparison.

Structurally a reference net restricted to a single parent per node
(``num_max = 1``, nearest covering reference), which is exactly the
net-vs-tree distinction of the paper's Fig. 2: with one parent, a query may
have to descend lists whose reference is far from Q even when another,
closer reference also covers the same data.  Implemented as a thin subclass
so both structures share traversal, counting, invariant, and construction
machinery — including the plan-based ``insert_plan``/``build_batched`` bulk
loader (cohort arbitration keeps only the nearest covering owner here, via
``num_max=1``) — space/query differences then isolate the multi-parent
effect, as in the paper's §8.2 comparison.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.counter import CountedDistance
from repro_torch.core.refnet import ReferenceNet
from repro_torch.distances import base as dist_base


class CoverTree(ReferenceNet):
    def __init__(self, dist: dist_base.Distance, data: np.ndarray, *,
                 eps_prime: float = 1.0, tight_bounds: bool = False,
                 counter: Optional[CountedDistance] = None):
        super().__init__(dist, data, eps_prime=eps_prime, num_max=1,
                         tight_bounds=tight_bounds, counter=counter)

    def check_invariants(self) -> None:
        super().check_invariants()
        for n in self.nodes.values():
            if n.idx != self.root:
                assert len(n.parents) == 1, "cover tree must be single-parent"
