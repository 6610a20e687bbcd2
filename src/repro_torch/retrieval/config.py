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
index          index kind from the retrieval registry
               (``refnet|covertree|mv|linear|embedding``)
execution      ``host`` (sequential frontier drive, classic counts),
               ``batched`` (frontier engine, one dispatch per merged
               round) or ``fleet`` (the elastic sharded fleet of
               ``launch/elastic.py``)
backend        counter backend: ``numpy | torch | kernel`` (default
               ``kernel``: every dispatch through the packed ragged-bucket
               dispatcher with fused ε-pruning — the hand-written CUDA
               wavefront kernel on a CUDA device, its plain torch version on
               the CPU); host, batched and fleet execution all evaluate on it
device         where the ``torch`` / ``kernel`` backends (and the fleet's
               one-shot query) evaluate: ``"cuda"`` (default) or ``"cpu"``.
               Building on ``"cuda"`` without a card raises; nothing falls
               back to the CPU
lb_cascade     tiered LB policy screening verdict frontiers before the
               exact DP: ``"off" | "endpoint" | "envelope"`` (legacy
               booleans normalize to off/endpoint).  ``envelope`` runs the
               O(B*L) envelope bound on the endpoint survivors — on the
               device under the ``kernel`` backend.  Fleet execution
               accepts ``envelope`` only (gathered from precomputed FlatNet
               envelopes)
workers        fleet worker names (or an int count); fleet execution only
fleet_mode     fleet serving mode: ``rounds`` (default — shared-frontier
               round-based serving through the packed fused-ε dispatcher,
               eval counts match the host loop) or ``oneshot`` (one stacked
               device query over the flattened nets); fleet execution only
eps_prime,     index tuning knobs (reference-net radii / parent cap /
num_max,       exact-vs-Lemma-4 bounds / MV reference count)
tight_bounds,
mv_refs
bulk_build     build hierarchies through the cohort loader (default);
               ``False`` = sequential Alg.-1 inserts (legacy counts)
max_cohort     cohort size cap for the bulk loader / fleet shard builds
serve_*        continuous-batching serve engine (``Retriever.serve()``):
               ``serve_max_inflight`` caps concurrently in-flight
               requests, ``serve_admission`` picks the admission policy
               (``tick`` = newcomers merge into the next shared round,
               ``greedy`` = one dedicated first round), and
               ``serve_snapshot_dir`` hosts the zero-downtime
               snapshot/restore checkpoints (default: a fresh temp dir)
=============  =============================================================

Knobs of the reference that configure only its Pallas TPU schedule are
dropped: ``interpret`` (interpret-mode Pallas off-TPU), ``kernel_exec``
(banded Pallas kernel vs ``lax.scan`` twin) and ``kernel_tile`` (VMEM band
depth); so is ``kernel_backend``, the reference's alias of ``backend``.
On a CUDA device the kernel runs; its plain torch version is reached only
for CPU tensors, or by calling it by name.

``to_json`` / ``from_json`` round-trip the config.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

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
    workers: Optional[Tuple[str, ...]] = None
    fleet_mode: str = "rounds"
    eps_prime: float = 1.0
    num_max: Optional[int] = None
    tight_bounds: bool = False
    mv_refs: int = 5
    bulk_build: bool = True
    max_cohort: int = 256
    serve_max_inflight: int = 32
    serve_admission: str = "tick"
    serve_snapshot_dir: Optional[str] = None

    # -- validation (the whole point: fail at construction, not mid-query) --

    def __post_init__(self):
        if isinstance(self.workers, int):
            object.__setattr__(
                self, "workers",
                tuple(f"w{i}" for i in range(self.workers)))
        elif self.workers is not None:
            object.__setattr__(self, "workers", tuple(self.workers))
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
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}; got {self.backend!r}")
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu'; got {self.device!r}")

        if self.lam is not None:
            if self.lam < 2:
                raise ValueError(f"lam must be >= 2; got {self.lam}")
            if not 0 <= self.lambda0 < self.lam // 2:
                raise ValueError(
                    f"lambda0 must satisfy 0 <= lambda0 < lam/2 "
                    f"(= {self.lam // 2}); got {self.lambda0}")
            dist_base.require_consistent(dist)   # segmentation filter, Def. 1
            if self.index == "embedding":
                raise ValueError(
                    "index 'embedding' serves fixed-length pooled vectors; "
                    "it cannot back the subsequence-matching pipeline "
                    "(set lam=None)")
        if spec.requires_metric:
            dist_base.require_metric(dist)       # indexed path, §5
        if self.mv_refs < 1:
            raise ValueError(f"mv_refs must be >= 1; got {self.mv_refs}")

        if self.execution == "fleet":
            if not self.workers:
                raise ValueError(
                    "fleet execution needs workers (a name tuple or count)")
            if self.lam is not None:
                raise ValueError(
                    "fleet execution serves window-level range queries; "
                    "the matching pipeline (lam) runs host/batched")
            if self.index != "refnet":
                raise ValueError(
                    "fleet execution shards per-worker reference nets; "
                    f"index must be 'refnet', got {self.index!r}")
            if self.lb_cascade == "endpoint":
                raise ValueError(
                    "fleet execution supports lb_cascade='envelope' only "
                    "(gathered from precomputed FlatNet envelopes); the "
                    "endpoint tier belongs to the host/batched frontier "
                    "engine")
            from repro_torch.launch.elastic import FLEET_MODES
            if self.fleet_mode not in FLEET_MODES:
                raise ValueError(
                    f"fleet_mode must be one of {FLEET_MODES}; "
                    f"got {self.fleet_mode!r}")
        else:
            if self.workers is not None:
                raise ValueError(
                    f"workers only apply to fleet execution "
                    f"(execution={self.execution!r})")
            if self.fleet_mode != "rounds":
                raise ValueError(
                    f"fleet_mode only applies to fleet execution "
                    f"(execution={self.execution!r})")

        # serve knobs (Retriever.serve(); validated here regardless of
        # execution so a bad serving config fails at construction, not when
        # the engine is finally asked for)
        from repro_torch.serve.engine import ADMISSION_POLICIES
        if self.serve_max_inflight < 1:
            raise ValueError(
                f"serve_max_inflight must be >= 1; "
                f"got {self.serve_max_inflight}")
        if self.serve_admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"serve_admission must be one of {ADMISSION_POLICIES}; "
                f"got {self.serve_admission!r}")

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
        if self.workers is not None:
            d["workers"] = list(self.workers)
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
