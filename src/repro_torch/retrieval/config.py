"""`RetrievalConfig` — ONE declarative description of a retrieval stack.

The paper's pitch is genericity: one framework, any consistent distance,
any workload.  This dataclass is where *what* (distance, query scope) and
*how* (index kind, counter backend, device, execution policy) meet,
validated once at construction:

=============  =============================================================
field          meaning
=============  =============================================================
distance       registry name (or ``Distance`` instance) — §4 consistency /
               metricity requirements are checked here
lam, lambda0   subsequence-matching scope (§3.2).  ``lam=None`` = plain
               window-level retrieval over the database rows; ``lam`` set =
               the full 5-step matching pipeline
index          index kind from the retrieval registry (``refnet|linear``)
execution      ``host`` (sequential frontier drive, classic counts) or
               ``batched`` (frontier engine, one dispatch per merged round)
backend        counter backend: ``numpy | torch | kernel`` (default
               ``kernel``: every dispatch through the packed ragged-bucket
               dispatcher with fused ε-pruning — the hand-written CUDA
               wavefront kernel on a CUDA device, its plain torch version on
               the CPU); host and batched execution both evaluate on it
device         where the ``torch`` / ``kernel`` backends evaluate:
               ``"cuda"`` (default) or ``"cpu"``.  Building on ``"cuda"``
               without a card raises; nothing falls back to the CPU
lb_cascade     tiered LB policy screening verdict frontiers before the
               exact DP: ``"off" | "endpoint" | "envelope"`` (legacy
               booleans normalize to off/endpoint)
eps_prime,     reference-net tuning knobs (radii / parent cap /
num_max,       exact-vs-Lemma-4 bounds)
tight_bounds
bulk_build     build hierarchies through the cohort loader (default);
               ``False`` = sequential Alg.-1 inserts (legacy counts)
max_cohort     cohort size cap for the bulk loader
=============  =============================================================

Knobs of the reference that configure only its Pallas TPU schedule are
dropped: ``interpret`` (interpret-mode Pallas off-TPU), ``kernel_exec``
(banded Pallas kernel vs ``lax.scan`` twin) and ``kernel_tile`` (VMEM band
depth); so is ``kernel_backend``, the reference's alias of ``backend``.
On a CUDA device the kernel runs; its plain torch version is reached only
for CPU tensors, or by calling it by name.  Fleet execution (``workers``,
``fleet_mode``), the serve engine (``serve_*``) and the MV index
(``mv_refs``) come with their slices; until then ``execution="fleet"``
raises ``NotImplementedError``, as does ``lb_cascade="envelope"`` under
the ``kernel`` backend (the device envelope kernel is a later slice; a
host substitute would change the ``lb_pruned`` counts).

``to_json`` / ``from_json`` round-trip the config.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Union

import torch

from repro_torch.core.counter import BACKENDS
from repro_torch.distances import base as dist_base
from repro_torch.retrieval import registry

EXECUTIONS = ("host", "batched", "fleet")


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    distance: Union[str, dist_base.Distance]
    lam: Optional[int] = None
    lambda0: int = 1
    index: str = "refnet"
    execution: str = "batched"
    backend: str = "kernel"
    device: str = "cuda"
    lb_cascade: Union[bool, str] = False
    eps_prime: float = 1.0
    num_max: Optional[int] = None
    tight_bounds: bool = False
    bulk_build: bool = True
    max_cohort: int = 256

    # -- validation (the whole point: fail at construction, not mid-query) --

    def __post_init__(self):
        # normalize the tiered LB policy once (legacy booleans included),
        # so every engine below sees a canonical tier string and the JSON
        # round-trip serializes the normalized form
        from repro_torch.distances import bounds as dist_bounds
        object.__setattr__(self, "lb_cascade",
                           dist_bounds.normalize_tier(self.lb_cascade))

        dist = dist_base.resolve(self.distance)   # raises on unknown names
        spec = registry.resolve_index(self.index)  # raises on unknown kinds
        if self.execution not in EXECUTIONS:
            raise ValueError(
                f"execution must be one of {EXECUTIONS}; "
                f"got {self.execution!r}")
        if self.execution == "fleet":
            raise NotImplementedError(
                "execution='fleet' (the elastic sharded fleet) is not ported "
                "yet (ROADMAP.md Queue 1: elastic fleet)")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}; got {self.backend!r}")
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu'; got {self.device!r}")
        if self.lb_cascade == "envelope" and self.backend == "kernel":
            raise NotImplementedError(
                "lb_cascade='envelope' under the kernel backend needs the "
                "device envelope kernel, which is not ported yet "
                "(ROADMAP.md Queue 1: device LB-envelope tier)")

        if self.lam is not None:
            if self.lam < 2:
                raise ValueError(f"lam must be >= 2; got {self.lam}")
            if not 0 <= self.lambda0 < self.lam // 2:
                raise ValueError(
                    f"lambda0 must satisfy 0 <= lambda0 < lam/2 "
                    f"(= {self.lam // 2}); got {self.lambda0}")
            dist_base.require_consistent(dist)   # segmentation filter, Def. 1
        if spec.requires_metric:
            dist_base.require_metric(dist)       # indexed path, §5

    # -- resolution helpers --------------------------------------------------

    @property
    def dist(self) -> dist_base.Distance:
        return dist_base.resolve(self.distance)

    @property
    def index_spec(self) -> registry.IndexSpec:
        return registry.resolve_index(self.index)

    def replace(self, **changes) -> "RetrievalConfig":
        return dataclasses.replace(self, **changes)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        dist = self.dist
        if isinstance(self.distance, dist_base.Distance):
            # an instance serializes by name, so the name must round-trip
            # back to the SAME distance when the JSON is loaded
            try:
                registered = dist_base.get(dist.name) is dist
            except KeyError:
                registered = False
            if not registered:
                raise ValueError(
                    f"distance {dist.name!r} is not in the registry; "
                    "register it (repro_torch.retrieval.register_distance) "
                    "before serializing this config")
        d["distance"] = dist.name
        return d

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "RetrievalConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(
                f"unknown RetrievalConfig fields: {sorted(extra)}")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "RetrievalConfig":
        return cls.from_dict(json.loads(s))
