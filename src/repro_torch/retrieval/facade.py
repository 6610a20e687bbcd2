"""The unified retrieval facade: ONE entry point over every index and
execution engine.

::

    from repro_torch.retrieval import RetrievalConfig, Retriever

    r = Retriever.build(RetrievalConfig("levenshtein", lam=16), seqs)
    rs = r.query(Q).range(2.0)          # type I   -> MatchPairs
    rs = r.query(Q).longest(2.0)        # type II  -> longest MatchPair
    rs = r.query(Q).nearest()           # type III -> nearest MatchPair
    rs = r.batch(queries).range(2.0)    # per-query hit lists

Two execution engines hide behind one fluent query-plan API, selected by
the config:

* ``lam`` set, execution ``host|batched`` — the 5-step subsequence
  matching pipeline (``core/matching.py``), hits are
  :class:`~repro_torch.core.matching.MatchPair`;
* ``lam=None``, execution ``host|batched`` — window-level retrieval over
  the database rows through the registry's index kinds on the
  frontier-plan substrate, hits are window ids.

The reference's third engine, the elastic fleet (``execution="fleet"``,
:meth:`Retriever.elastic`, :meth:`Retriever.serve`), is not ported yet and
raises ``NotImplementedError``.

Every call returns a uniform :class:`ResultSet`: hits plus the
``{query, build}`` exact-evaluation buckets and dispatch counts of the
counter underneath — the same currency as the paper's pruning figures, so
facade calls are count-identical to the direct code paths and to the
reference package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import _deprecation
from repro_torch.retrieval.config import RetrievalConfig

#: doubling cap for auto-ranged ``nearest()`` (no eps_max given)
_MAX_DOUBLINGS = 60


@dataclasses.dataclass
class ResultSet:
    """Uniform query result: hits + evaluation accounting.

    ``hits`` is a list of :class:`~repro_torch.core.matching.MatchPair`
    (matcher mode) or window ids (window mode); for ``batch()`` plans it is
    a per-query list of such lists.  ``stats`` always carries the
    ``{"query", "build"}`` exact-eval buckets and the dispatch counts;
    batched window-level executions add ``rounds``.  ``distances`` is
    filled by window-mode ``nearest()``.
    """

    hits: list
    stats: Dict[str, int]
    distances: Optional[list] = None

    def __iter__(self):
        return iter(self.hits)

    def __len__(self) -> int:
        return len(self.hits)

    def __bool__(self) -> bool:
        return bool(self.hits)

    @property
    def first(self):
        return self.hits[0] if self.hits else None


class QueryPlan:
    """A fluent, immutable description of one query (or query batch).

    Terminal calls — :meth:`range`, :meth:`nearest`, :meth:`longest` —
    compile the plan onto the configured engine and return a
    :class:`ResultSet`.  Modifiers return new plans:

    * :meth:`via` — override the execution policy for this call only
      (``host`` vs ``batched``);
    * :meth:`lb` — override the config's LB-cascade tier for this call
      (``"off" | "endpoint" | "envelope"``, legacy booleans accepted; hit
      sets are unchanged by construction — only exact-eval counts drop);
    * :meth:`dead` — fleet worker masking; not ported yet (raises).
    """

    def __init__(self, retriever: "Retriever", queries: List[np.ndarray],
                 is_batch: bool, execution: Optional[str] = None,
                 lb_cascade: Optional[bool] = None):
        self._r = retriever
        self._queries = queries
        self._is_batch = is_batch
        self._execution = execution
        self._lb = lb_cascade

    def _clone(self, **kw) -> "QueryPlan":
        args = dict(execution=self._execution, lb_cascade=self._lb)
        args.update(kw)
        return QueryPlan(self._r, self._queries, self._is_batch, **args)

    def via(self, execution: str) -> "QueryPlan":
        allowed = ("host", "batched")
        if execution not in allowed:
            raise ValueError(
                f"via() accepts {allowed} on this retriever; "
                f"got {execution!r}")
        return self._clone(execution=execution)

    def lb(self, tier=True) -> "QueryPlan":
        from repro_torch.distances import bounds as dist_bounds
        tier = dist_bounds.normalize_tier(tier)
        if tier == "envelope" and self._r.config.backend == "kernel":
            raise NotImplementedError(
                "lb('envelope') under the kernel backend needs the device "
                "envelope kernel, which is not ported yet (ROADMAP.md "
                "Queue 1: device LB-envelope tier)")
        return self._clone(lb_cascade=tier)

    def dead(self, *workers: str) -> "QueryPlan":
        raise NotImplementedError(
            "dead() masks fleet workers; the elastic fleet is not ported "
            "yet (ROADMAP.md Queue 1: elastic fleet)")

    # -- terminals -----------------------------------------------------------

    def range(self, eps: float) -> ResultSet:
        return self._r._range(self, float(eps))

    def nearest(self, eps_max: Optional[float] = None, *,
                tol: float = 1e-2) -> ResultSet:
        return self._r._nearest(self, eps_max, tol)

    def longest(self, eps: float) -> ResultSet:
        return self._r._longest(self, float(eps))


# -- engines ------------------------------------------------------------------


class _MatcherEngine:
    """lam set: the 5-step matching pipeline (``SubsequenceMatcher``)."""

    def __init__(self, cfg: RetrievalConfig, seqs):
        from repro_torch.core.matching import SubsequenceMatcher
        self.matcher = SubsequenceMatcher(
            cfg.dist, cfg.lam, cfg.lambda0, index=cfg.index,
            eps_prime=cfg.eps_prime, num_max=cfg.num_max,
            tight_bounds=cfg.tight_bounds,
            backend=cfg.backend, lb_cascade=cfg.lb_cascade,
            batched=(cfg.execution == "batched"),
            bulk_build=cfg.bulk_build, device=cfg.device).build(seqs)

    @property
    def counter(self):
        return self.matcher.index.counter

    @contextlib.contextmanager
    def overrides(self, execution: Optional[str],
                  lb: Optional[bool]):
        """Per-call execution/LB toggles, restored afterwards."""
        m = self.matcher
        prev = (m.batched, m.lb_cascade, m.engine.lb_cascade)
        if execution is not None:
            m.batched = execution == "batched"
        if lb is not None:
            from repro_torch.distances import bounds as dist_bounds
            tier = dist_bounds.normalize_tier(lb)
            m.lb_cascade = tier
            m.engine.lb_cascade = tier
        try:
            yield
        finally:
            m.batched, m.lb_cascade, m.engine.lb_cascade = prev

    def range(self, Q, eps):
        return self.matcher.query_range(Q, eps)

    def nearest(self, Q, eps_max, tol):
        return self.matcher.query_nearest(Q, eps_max, tol=tol)

    def longest(self, Q, eps):
        return self.matcher.query_longest(Q, eps)

    def has_hits(self, Q, eps, execution=None, lb=None) -> bool:
        # execution/lb are already applied by the enclosing overrides()
        return bool(self.matcher.segment_hits(Q, eps))


class _WindowEngine:
    """lam=None: window-level retrieval over the database rows."""

    def __init__(self, cfg: RetrievalConfig, data):
        from repro_torch.core.counter import CountedDistance
        self.cfg = cfg
        self.spec = cfg.index_spec
        dist = cfg.dist
        data = self.spec.prepare_data(data)
        self.counter = CountedDistance(dist, data,
                                       backend=cfg.backend,
                                       device=cfg.device)
        self.index = self.spec.factory(dist, data, counter=self.counter,
                                       **self.spec.tuning(cfg))
        if self.spec.bulk and cfg.bulk_build:
            self.index.build_batched(max_cohort=cfg.max_cohort)
        else:
            self.index.build()
        self.rounds = 0   # merged engine rounds across batched calls

    def _rows(self, queries) -> List[np.ndarray]:
        return [self.spec.prepare_query(q) for q in queries]

    def range_many(self, queries, eps, execution,
                   lb: Optional[bool] = None) -> List[List[int]]:
        from repro_torch.core.batch_engine import BatchEngine
        cascade = self.cfg.lb_cascade if lb is None else lb
        rows = self._rows(queries)
        if execution == "host":
            # via("host") contract: the sequential per-query loop IS the
            # requested execution mode
            return [self.index.range_query(q, eps, lb_cascade=cascade)
                    for q in rows]
        # batched: ALL plans — every length bucket — through ONE engine run
        # (each merged round is one packed ragged-bucket dispatch)
        if not rows:
            return []
        engine = BatchEngine(self.counter, lb_cascade=cascade)
        out = engine.run([self.index.range_query_plan(eps) for _ in rows],
                         rows, eps)
        self.rounds += engine.rounds
        return out

    def nearest_one(self, q, eps_max, tol, execution,
                    lb: Optional[bool] = None):
        """Binary search on eps over range queries (cf. paper type III)."""
        row = self.spec.prepare_query(q)
        lo, hi = 0.0, float(eps_max)
        if not self.range_many([q], hi, execution, lb)[0]:
            return None
        while hi - lo > tol:
            mid = 0.5 * (lo + hi)
            if self.range_many([q], mid, execution, lb)[0]:
                hi = mid
            else:
                lo = mid
        hits = self.range_many([q], hi, execution, lb)[0]
        ds = self.counter.eval(row, hits)
        best = int(np.argmin(ds))
        return int(hits[best]), float(ds[best])

    def has_hits(self, q, eps, execution="host",
                 lb: Optional[bool] = None) -> bool:
        return bool(self.range_many([q], eps, execution, lb)[0])


# -- the facade ---------------------------------------------------------------


class Retriever:
    """One object per configured retrieval stack; see the module docstring.

    Build with :meth:`Retriever.build` — the constructor is internal.
    """

    def __init__(self, config: RetrievalConfig, engine, mode: str):
        self.config = config
        self._engine = engine
        self._mode = mode   # "matcher" | "window"

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, config: RetrievalConfig, data) -> "Retriever":
        """Build the configured stack over ``data``.

        ``data`` is a sequence list for the matching pipeline (``lam``
        set), or a ``(N, l[, d])`` window array for window-level retrieval.
        Runs on ``config.device``; asking for the card on a machine without
        one raises ``RuntimeError``.
        """
        if not isinstance(config, RetrievalConfig):
            raise TypeError(
                f"expected a RetrievalConfig; got {type(config).__name__}")
        device_mod.resolve(config.device)
        with _deprecation.facade_construction():
            if config.lam is not None:
                return cls(config, _MatcherEngine(config, data), "matcher")
            return cls(config, _WindowEngine(config, data), "window")

    # -- fluent entry points -------------------------------------------------

    def query(self, Q) -> QueryPlan:
        """Plan a single query (sequence or window)."""
        return QueryPlan(self, [np.asarray(Q)], is_batch=False)

    def batch(self, queries) -> QueryPlan:
        """Plan a batch of queries (answered concurrently where the
        execution policy allows: the frontier engine)."""
        return QueryPlan(self, [np.asarray(q) for q in queries],
                         is_batch=True)

    def elastic(self):
        """Fleet controls (resize / dead-worker masking) — not ported yet."""
        raise NotImplementedError(
            "elastic() needs the elastic fleet, which is not ported yet "
            "(ROADMAP.md Queue 1: elastic fleet)")

    def serve(self, eps: float = 1.0):
        """The continuous-batching serve engine — not ported yet."""
        raise NotImplementedError(
            "serve() needs the serve engine, which is not ported yet "
            "(ROADMAP.md Queue 1: serving)")

    # -- introspection -------------------------------------------------------

    @property
    def matcher(self):
        """The underlying ``SubsequenceMatcher`` (matcher mode only)."""
        if self._mode != "matcher":
            raise ValueError("no matcher: lam is not set on this config")
        return self._engine.matcher

    @property
    def index(self):
        """The underlying index object (window mode only)."""
        if self._mode != "window":
            raise ValueError("no bare index: this retriever runs "
                             f"{self._mode} mode")
        return self._engine.index

    @property
    def counter(self):
        """The :class:`~repro_torch.core.counter.CountedDistance` every
        evaluation of this stack goes through."""
        return self._engine.counter

    @property
    def meta(self):
        """Window metadata (matcher mode: step-1 partition windows)."""
        return self.matcher.meta

    def eval_stats(self) -> Dict[str, int]:
        """Cumulative ``{query, build}`` exact-eval buckets + dispatches."""
        c = self._engine.counter
        return {"query": c.count, "build": c.build_count,
                "dispatches": c.dispatches,
                "build_dispatches": c.build_dispatches, "lb": c.lb_count}

    def reset_counter(self) -> None:
        """Zero the query-side counters (build buckets included, matching
        the legacy ``reset_counter`` semantics)."""
        self._engine.counter.reset()
        if self._mode == "window":
            self._engine.rounds = 0

    # -- terminal implementations -------------------------------------------

    def _snap(self) -> Dict[str, int]:
        return dict(self.eval_stats())

    def _finish(self, hits, before: Dict[str, int], distances=None,
                rounds: Optional[int] = None) -> ResultSet:
        after = self.eval_stats()
        stats = {"query": after["query"] - before["query"],
                 "build": after["build"],
                 "dispatches": after["dispatches"] - before["dispatches"],
                 "lb": after["lb"] - before["lb"],
                 "build_dispatches": after["build_dispatches"]}
        if rounds is not None:
            stats["rounds"] = rounds
        return ResultSet(hits=hits, stats=stats, distances=distances)

    def _execution(self, plan: QueryPlan) -> str:
        if plan._execution is not None:
            return plan._execution
        return self.config.execution

    def _range(self, plan: QueryPlan, eps: float) -> ResultSet:
        before = self._snap()
        execution = self._execution(plan)
        rounds = None
        if self._mode == "matcher":
            with self._engine.overrides(execution, plan._lb):
                per_q = [self._engine.range(Q, eps) for Q in plan._queries]
        else:
            r0 = self._engine.rounds
            per_q = self._engine.range_many(plan._queries, eps, execution,
                                            plan._lb)
            if execution == "batched":
                rounds = self._engine.rounds - r0
        hits = per_q if plan._is_batch else per_q[0]
        return self._finish(hits, before, rounds=rounds)

    def _auto_eps_max(self, Q, execution, lb=None) -> Optional[float]:
        """Double eps from the index scale until the filter fires."""
        e = max(self.config.eps_prime, 1e-6)
        for _ in range(_MAX_DOUBLINGS):
            if self._engine.has_hits(Q, e, execution, lb):
                return e
            e *= 2.0
        return None

    def _nearest(self, plan: QueryPlan, eps_max: Optional[float],
                 tol: float) -> ResultSet:
        before = self._snap()
        execution = self._execution(plan)
        bests, dists = [], []
        if self._mode == "matcher":
            with self._engine.overrides(execution, plan._lb):
                for Q in plan._queries:
                    hi = eps_max if eps_max is not None \
                        else self._auto_eps_max(Q, execution, plan._lb)
                    m = None if hi is None \
                        else self._engine.nearest(Q, hi, tol)
                    bests.append(m)
                    dists.append(m.distance if m is not None else None)
        else:
            for Q in plan._queries:
                hi = eps_max if eps_max is not None \
                    else self._auto_eps_max(Q, execution, plan._lb)
                got = None if hi is None \
                    else self._engine.nearest_one(Q, hi, tol, execution,
                                                  plan._lb)
                bests.append(got[0] if got else None)
                dists.append(got[1] if got else None)
        if not plan._is_batch:
            bests, dists = bests[0], dists[0]
            bests = [] if bests is None else [bests]
            dists = [] if dists is None else [dists]
        return self._finish(bests, before, distances=dists)

    def _longest(self, plan: QueryPlan, eps: float) -> ResultSet:
        if self._mode != "matcher":
            raise ValueError(
                "longest() is a subsequence-matching query (type II); "
                "set lam on the config")
        before = self._snap()
        with self._engine.overrides(self._execution(plan), plan._lb):
            bests = [self._engine.longest(Q, eps) for Q in plan._queries]
        if not plan._is_batch:
            bests = [] if bests[0] is None else [bests[0]]
        return self._finish(bests, before)
