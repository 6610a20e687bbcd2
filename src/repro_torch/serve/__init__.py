"""Continuous-batching retrieval serving.

The serve layer turns the round-based fleet substrate into a front end
for asynchronous traffic: requests admitted mid-flight join the shared
frontier cadence at the next round boundary, every in-flight request's
next round merges into ONE packed device dispatch per tick, and a live
fleet snapshots/restores so ``resize()`` swaps reshards in with zero
downtime.
"""

from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.loadgen import OpenLoopLoadGen, poisson_schedule
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.snapshot import FleetSnapshotManager

__all__ = [
    "FleetSnapshotManager",
    "OpenLoopLoadGen",
    "Request",
    "RequestQueue",
    "ServeConfig",
    "ServeEngine",
    "poisson_schedule",
]
