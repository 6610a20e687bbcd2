"""Elastic scaling for the sharded retrieval fleet — on the batched substrate.

Windows are assigned to shards by rendezvous (highest-random-weight)
hashing: when the worker set changes, ONLY the windows whose owner changed
move — each survivor keeps ~n/k of its data, so an N->N±1 resize touches
~1/N of the index instead of all of it.  Each shard owns an independent
reference net (metric-space partitioning keeps range queries exact by
union; DESIGN.md §4.3).

The elastic layer is the fleet-serving front end of the batched
substrate:

* **Construction** — every shard builds through
  :meth:`~repro_torch.core.refnet.ReferenceNet.build_batched` on a
  caller-selected :class:`~repro_torch.core.counter.CountedDistance`
  backend (``kernel`` by default: the hand-written wavefront kernel on the
  card; ``torch`` / ``numpy``) on an explicit ``device``, and is
  immediately flattened (:func:`~repro_torch.core.distributed.flatten_net`)
  so it can serve device queries.
* **Resharding** — :meth:`ElasticIndex.resize` never rebuilds a surviving
  shard from scratch.  Windows that rendezvous moves *out* are deleted from
  the host net (Alg. 2 re-homing) and masked out of the shard's
  :class:`~repro_torch.core.distributed.FlatNet` with zero evaluations
  (:meth:`FlatNet.remove`); windows that move *in* are appended to the
  shard's database (:meth:`ReferenceNet.extend_data`), bulk-loaded through
  the cohort loader (``build_batched(order=new_ids)``), and attached to the
  flat net incrementally (:meth:`FlatNet.append`) under a pivot ancestor
  found by walking the new node's parent chain.  Only a brand-new worker
  (or the rare shard whose *root* window moved away) pays a full build, so
  an N->N+1 resize re-spends ~1/N of the original ``build``-bucket cost
  (held to at most 2/N in ``chip_smoke.py``'s fleet phase, the gate of the
  reference's ``benchmarks/bench_elastic.py``).
* **Serving** — :meth:`ElasticIndex.range_query_batch` answers the fleet
  in one of two batched modes:

  - ``mode="rounds"`` (the default): the **shared-frontier, round-based
    path**.  Every alive shard contributes one Alg.-3 range-query plan per
    query, and a
    :class:`~repro_torch.core.batch_engine.FleetBatchEngine` drives
    them all in lockstep — each merged round is ONE evaluator call across
    all shards and all length buckets (the packed ragged-bucket kernel
    dispatch with fused ε-pruning on the ``kernel`` backend), with hit
    lists flowing back through each shard's ``gids`` to global ids.  The
    frontier's round-by-round pruning is preserved exactly: evaluation
    counts match the host per-shard loop row for row, tallied in
    :attr:`ElasticIndex.device_stats` (never the host counters).
  - ``mode="oneshot"``: the stacked path — the alive shards' FlatNets
    merge via ``merge_flats`` into ONE
    :func:`~repro_torch.core.distributed.fleet_range_query` device query
    (one pivot launch, one survivor launch), but only the flat net's
    pivot/ring bounds prune, so it evaluates far more candidates than the
    frontier does (kept for single-query-call serving and as the stacked
    parity path).

  ``dead`` workers are masked out of either path (their plans are never
  admitted / their columns never merged), so a lost worker degrades the
  answer to the union of the survivors (exact on their partitions) until
  the caller ``resize``\\ s it away.  ``batched=False`` on
  :meth:`ElasticIndex.range_query` keeps the classic host per-shard
  pointer-chasing loop — same hit sets, used as the parity oracle.

Accounting: :meth:`ElasticIndex.eval_count` reports the fleet's host-side
counter totals as separate ``{"query", "build"}`` buckets (construction
and resharding land in ``build``, host-mode queries in ``query``; counts
of retired shards are retained so both buckets are monotone across
resizes), and :attr:`ElasticIndex.device_stats` accumulates the device
path's pivot/member evaluation totals.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import spans


def _hrw_score(window_id: int, worker: str) -> int:
    h = hashlib.blake2b(f"{window_id}:{worker}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big")


def assign(window_ids: Sequence[int], workers: Sequence[str]
           ) -> Dict[str, List[int]]:
    """Rendezvous-hash every window to a worker."""
    out: Dict[str, List[int]] = {w: [] for w in workers}
    for wid in window_ids:
        best = max(workers, key=lambda w: _hrw_score(wid, w))
        out[best].append(wid)
    return out


def moved_fraction(before: Dict[str, List[int]], after: Dict[str, List[int]]
                   ) -> float:
    owner_b = {wid: w for w, wids in before.items() for wid in wids}
    owner_a = {wid: w for w, wids in after.items() for wid in wids}
    moved = sum(1 for wid, w in owner_a.items()
                if owner_b.get(wid) != w)
    return moved / max(len(owner_a), 1)


@dataclasses.dataclass
class _Shard:
    """One worker's slice of the fleet: host net + device flat + id map.

    ``gids[i]`` is the global window id stored at local row ``i`` of the
    shard's database.  Rows are not recycled in place: a window that
    reshards away leaves a stale row behind (masked out of both the net
    and the flat), a window that reshards in appends a fresh row — so
    local ids stay stable across incremental resizes, and ``resize``
    compacts a shard (full rebuild) once stale rows outnumber live ones."""
    net: "object"               # ReferenceNet over the shard-local database
    flat: "object"              # FlatNet serving the device path
    gids: np.ndarray            # (rows,) local row -> global window id


#: batched serving modes: shared-frontier rounds vs the one-shot stacked
#: device query (see the module docstring)
FLEET_MODES = ("rounds", "oneshot")


class ElasticIndex:
    """A set of per-shard reference nets that reshard incrementally and
    serve batched fleet queries round-based (shared frontier) or as one
    stacked device query.

    Deprecated as a *direct* public entry point since v0.1 — build through
    the facade instead::

        repro_torch.retrieval.Retriever.build(
            RetrievalConfig(dist, execution="fleet", workers=...), data)

    The facade delegates here, so behavior and counts are identical; this
    constructor shim will be removed in v0.2.  ``dist`` accepts a registry name or a ``Distance`` instance.  Shards
    evaluate on ``backend`` (default ``kernel``) on ``device`` (default:
    the card), where the one-shot query runs too."""

    def __init__(self, dist, data: np.ndarray, workers: List[str],
                 *, eps_prime: float = 1.0, tight_bounds: bool = True,
                 backend: str = "kernel", max_cohort: int = 256,
                 fleet_mode: str = "rounds", lb_cascade="off",
                 device=None):
        from repro_torch import device as device_mod
        from repro_torch.core import _deprecation
        from repro_torch.distances import base as dist_base
        from repro_torch.distances import bounds as dist_bounds
        _deprecation.warn_legacy("ElasticIndex")
        if fleet_mode not in FLEET_MODES:
            raise ValueError(
                f"fleet_mode must be one of {FLEET_MODES}; "
                f"got {fleet_mode!r}")
        self.lb_cascade = dist_bounds.normalize_tier(lb_cascade)
        if self.lb_cascade == "endpoint":
            raise ValueError(
                "the fleet path supports lb_cascade='envelope' only (the "
                "endpoint tier belongs to the host/batched frontier engine)")
        self.dist = dist_base.require_metric(dist)
        self.data = np.asarray(data)
        self.eps_prime = eps_prime
        self.tight = tight_bounds
        self.backend = backend
        self.device = device_mod.resolve(device)
        self.max_cohort = max_cohort
        self.fleet_mode = fleet_mode
        self.workers = list(workers)
        self.assignment = assign(range(len(data)), self.workers)
        self._retired = {"query": 0, "build": 0}
        self._merged = None     # (dead_ix, merge_flats result) serving cache
        self._round_eval = None  # resolved (evaluate, fused) for mode=rounds
        self.device_stats = {"pivot_evals": 0, "member_evals": 0,
                             "fused_pruned": 0, "total_evals": 0,
                             "lb_rows": 0, "lb_pruned": 0,
                             "rounds": 0, "device_queries": 0}
        self.shards: Dict[str, Optional[_Shard]] = {
            w: self._build_shard(self.assignment[w]) for w in self.workers}

    # -- construction -------------------------------------------------------

    def _build_shard(self, ids: Sequence[int]) -> Optional[_Shard]:
        """Full cohort build of one shard on the selected backend."""
        from repro_torch.core.counter import CountedDistance
        from repro_torch.core.distributed import flatten_net
        from repro_torch.core.refnet import ReferenceNet
        if not len(ids):
            return None
        ids = np.asarray(ids, np.int64)
        counter = CountedDistance(self.dist, self.data[ids],
                                  backend=self.backend, device=self.device)
        net = ReferenceNet(self.dist, counter.data,
                           eps_prime=self.eps_prime,
                           tight_bounds=self.tight, counter=counter)
        net.build_batched(max_cohort=self.max_cohort)
        return _Shard(net=net, flat=flatten_net(net), gids=ids)

    def _retire(self, shard: _Shard) -> None:
        """Fold a dropped/replaced shard's counters into the running totals
        so ``eval_count`` buckets stay monotone across resizes."""
        self._retired["query"] += shard.net.counter.count
        self._retired["build"] += shard.net.counter.build_count

    # -- elastic resharding -------------------------------------------------

    def resize(self, workers: List[str]) -> float:
        """Change the worker set; reshard incrementally.

        Surviving shards shrink (Alg.-2 deletes + zero-eval ``FlatNet``
        masking) and/or grow (``extend_data`` + cohort bulk load +
        ``FlatNet.append``); a full ``build_batched`` is paid only by
        brand-new workers, the rare shard whose root window moved away,
        and shards whose accumulated stale rows outnumber their live ones
        (churn compaction).  Returns the fraction of windows that moved."""
        new_assign = assign(range(len(self.data)), workers)
        frac = moved_fraction(self.assignment, new_assign)
        old_shards = self.shards
        new_shards: Dict[str, Optional[_Shard]] = {}
        for w in workers:
            old = old_shards.get(w)
            new_ids = new_assign[w]
            if old is not None and new_ids == self.assignment.get(w):
                new_shards[w] = old                     # untouched shard
                continue
            shard: Optional[_Shard] = None
            if old is not None and new_ids:
                old_set = set(self.assignment.get(w, ()))
                new_set = set(new_ids)
                lost = sorted(old_set - new_set)
                gained = sorted(new_set - old_set)
                # churn compaction, decided BEFORE spending any incremental
                # work: if stale rows would outnumber live windows, a full
                # rebuild is the cheaper (and smaller) shard
                rows_after = len(old.gids) + len(gained)
                live_after = len(old.net.nodes) - len(lost) + len(gained)
                if live_after * 2 >= rows_after:
                    shard = self._shrink(old, lost) if lost else old
                    if shard is not None and gained:
                        self._grow(shard, gained)
            if shard is None and new_ids:
                shard = self._build_shard(new_ids)  # new/root-loss/compaction
            new_shards[w] = shard
        carried = {id(s) for s in new_shards.values() if s is not None}
        for s in old_shards.values():
            if s is not None and id(s) not in carried:
                self._retire(s)
        self.assignment = new_assign
        self.workers = list(workers)
        self.shards = new_shards
        self._merged = None     # shard arrays changed: drop the serving cache
        return frac

    def _shrink(self, shard: _Shard, lost: Sequence[int]
                ) -> Optional[_Shard]:
        """Remove windows that resharded away.  Host net: Alg.-2 deletion
        (plain objects first, then references bottom-up, so a deleted
        reference never re-homes a child that is itself leaving).  Flat
        net: zero-eval member masking.  Returns None — full rebuild — only
        when the shard's root window itself moved away."""
        g2l = {int(g): i for i, g in enumerate(shard.gids)}
        local = [g2l[int(g)] for g in lost]
        net = shard.net
        if net.root in local:
            return None
        objs = [x for x in local if net.nodes[x].level < 0]
        refs = sorted((x for x in local if net.nodes[x].level >= 0),
                      key=lambda x: net.nodes[x].level)
        for x in objs + refs:
            net.delete(x)
        shard.flat.remove(local)
        return shard

    def _grow(self, shard: _Shard, gained: Sequence[int]) -> None:
        """Bulk-load windows that resharded in: extend the shard database,
        run the cohort loader over just the new ids, and attach each new
        window to the flat net under a pivot ancestor (walking the parent
        chain; link distances are reused where the pivot is the direct
        parent, the rest are one stacked build-bucket dispatch)."""
        gained = np.asarray(sorted(int(g) for g in gained), np.int64)
        rows = self.data[gained]
        net = shard.net
        new_local = net.extend_data(rows)
        shard.gids = np.concatenate([shard.gids, gained])
        net.build_batched(order=new_local, max_cohort=self.max_cohort)
        self._refresh_flat(shard, new_local, rows)

    def _refresh_flat(self, shard: _Shard, new_local: Sequence[int],
                      rows: np.ndarray) -> None:
        flat, net = shard.flat, shard.net
        pivot_row = {int(p): r
                     for r, p in enumerate(np.asarray(flat.pivot_ids))}
        prows: List[int] = []
        dists: List[float] = []
        need_l: List[int] = []
        need_r: List[int] = []
        need_at: List[int] = []
        for x in new_local:
            p = x
            while p not in pivot_row:
                p = net.nodes[p].parents[0]   # levels strictly increase
            prows.append(pivot_row[p])
            pn = net.nodes[p]
            if x in pn.children:
                dists.append(float(pn.child_dist[pn.children.index(x)]))
            else:
                need_l.append(p)
                need_r.append(x)
                need_at.append(len(dists))
                dists.append(0.0)
        if need_l:
            ds = net.counter.eval_pairs(need_l, need_r)
            for at, d in zip(need_at, ds):
                dists[at] = float(d)
        flat.append(prows, list(new_local), dists, new_data=rows)

    # -- serving ------------------------------------------------------------

    def range_query(self, q: np.ndarray, eps: float,
                    q_len: Optional[int] = None, dead: Sequence[str] = (),
                    *, batched: bool = True,
                    capacity: Optional[int] = None,
                    mode: Optional[str] = None) -> List[int]:
        """Fleet-wide query = union over shards (exact).  ``dead`` workers
        are skipped — results degrade gracefully and the caller can retry
        after `resize` (fault tolerance path).

        ``batched=True`` (default) serves through the batched fleet path
        (``mode``: see :meth:`range_query_batch`); ``batched=False`` is the
        host per-shard loop (same hits)."""
        q = np.asarray(q)
        qlen = len(q) if q_len is None else int(q_len)
        if not batched:
            out: List[int] = []
            for w in self.workers:
                s = self.shards.get(w)
                if w in dead or s is None:
                    continue
                # lint: allow[dispatch-in-loop] -- host per-shard parity loop: the sequential reference the stacked fleet path is asserted against
                for local in s.net.range_query(q, eps, qlen):
                    out.append(int(s.gids[local]))
            return sorted(out)
        return self.range_query_batch([q[:qlen]], eps, dead=dead,
                                      capacity=capacity, mode=mode)[0]

    def range_query_batch(self, qs: Union[np.ndarray, Sequence[np.ndarray]],
                          eps: float, *, dead: Sequence[str] = (),
                          capacity: Optional[int] = None,
                          mode: Optional[str] = None) -> List[List[int]]:
        """Batched fleet serving for a whole query batch.

        ``mode`` (default: the constructor's ``fleet_mode``, ``"rounds"``):

        * ``"rounds"`` — shared-frontier round-based serving: every alive
          shard runs one Alg.-3 range-query plan per query, all plans
          advance in lockstep, and each merged round is ONE evaluator call
          across all shards and all length buckets (the packed fused-ε
          kernel dispatch on the ``kernel`` backend).  Pruning — and the
          evaluation count — is identical to the host per-shard loop.
        * ``"oneshot"`` — the stacked path: ``merge_flats`` + ONE
          ``fleet_range_query`` device query for the whole batch
          (``capacity`` is reported in its stats).

        ``qs`` is a (Q, l[, d]) array or a sequence of query windows whose
        lengths may differ — mixed lengths ride the packed ragged-bucket
        dispatch with per-query lengths.  Returns the sorted global hit
        ids per query; ``dead`` workers are masked out of either path."""
        mode = self.fleet_mode if mode is None else mode
        if mode not in FLEET_MODES:
            raise ValueError(
                f"mode must be one of {FLEET_MODES}; got {mode!r}")
        rows = [np.asarray(q) for q in qs]
        if not rows:
            return []
        dead_ix = tuple(i for i, w in enumerate(self.workers)
                        if w in dead or self.shards.get(w) is None)
        if mode == "rounds":
            return self._round_query(rows, eps, dead_ix)
        return self._oneshot_query(rows, eps, dead_ix, capacity)

    # -- round-based serving (shared frontier, fused-ε pruning) -------------

    def _round_evaluator(self):
        """Resolve the round evaluator once: ``(evaluate, fused)``.

        On the ``kernel`` backend (with a registered kernel) a merged round
        goes straight through the packed ragged-bucket dispatcher with
        per-row shard provenance and fused ε-pruning — one wavefront launch
        per round, which returns the hit verdict and never materializes
        pruned candidates' distances.  Other backends evaluate the round in
        one batch call (values still preserve every ``<= eps`` verdict)."""
        if self._round_eval is not None:
            return self._round_eval
        from repro_torch.kernels import registry as kernel_registry
        if self.backend == "kernel" and kernel_registry.has(self.dist.name):
            from repro_torch.kernels.dispatch import packed_batch
            name, dev = self.dist.name, self.device

            def evaluate(xs, ys, lx, ly, eps_rows, shard_ids):
                out = packed_batch(name, xs, ys, lx, ly, eps=eps_rows,
                                   device=dev, shards=shard_ids)
                return (np.asarray(out.dist, np.float32),
                        int(np.asarray(out.pruned).sum()))

            self._round_eval = (evaluate, True)
        else:
            from repro_torch.core.counter import _resolve_backend
            batch = _resolve_backend(self.dist, self.backend, self.device)

            def evaluate(xs, ys, lx, ly, eps_rows, shard_ids):
                return np.asarray(batch(xs, ys, lx, ly), np.float32), 0

            self._round_eval = (evaluate, False)
        return self._round_eval

    def _round_query(self, rows: List[np.ndarray], eps: float,
                     dead_ix: Tuple[int, ...]) -> List[List[int]]:
        """Shared-frontier rounds across all alive shards (one evaluator
        call per merged round); evaluation totals land in
        :attr:`device_stats`, never the shards' host counters."""
        from repro_torch.core.batch_engine import FleetBatchEngine, \
            ShardPlans
        from repro_torch.kernels.dispatch import pad_ragged_rows
        qpad, q_lens = pad_ragged_rows(rows)
        groups = []
        for si, w in enumerate(self.workers):
            s = self.shards.get(w)
            if si in dead_ix or s is None:
                continue
            groups.append(ShardPlans(
                shard=si, data=s.net.data,
                plans=[s.net.range_query_plan(eps) for _ in rows],
                queries=qpad, q_lens=q_lens))
        lb_hook = None
        if self.lb_cascade == "envelope" and groups:
            # envelope tier over each shard's PRECOMPUTED FlatNet envelopes
            # (built once at flatten time, refreshed by append) — the hook
            # gathers stored boxes/masses per candidate id, no per-round
            # recomputation of O(rows * L) reductions
            from repro_torch.distances import bounds as dist_bounds
            envs = {}
            for si, w in enumerate(self.workers):
                s = self.shards.get(w)
                if s is not None and s.flat.envelopes is not None:
                    envs[si] = s.flat.envelopes
            if envs:
                name = self.dist.name

                def lb_hook(shard, idxs, q, q_len):
                    e = envs[shard].take(idxs)
                    xs = np.repeat(q[None], len(idxs), 0)
                    return dist_bounds.lb_envelope_rows(
                        name, xs, np.full(len(idxs), q_len, np.int64),
                        e.lo, e.hi, e.mass)

        evaluate, fused = self._round_evaluator()
        engine = FleetBatchEngine(evaluate, fused=fused, lb=lb_hook)
        per_group = engine.run(groups, eps)
        hits: List[set] = [set() for _ in rows]
        for grp, res in zip(groups, per_group):
            gids = self.shards[self.workers[grp.shard]].gids
            for qi, local in enumerate(res):
                hits[qi].update(int(gids[x]) for x in local)
        agg = self.device_stats
        agg["pivot_evals"] += engine.exact_evals
        agg["member_evals"] += engine.verdict_evals
        agg["fused_pruned"] += engine.fused_pruned
        agg["lb_rows"] += engine.lb_rows
        agg["lb_pruned"] += engine.lb_pruned
        agg["total_evals"] += engine.exact_evals + engine.verdict_evals
        agg["rounds"] += engine.rounds
        agg["device_queries"] += 1
        return [sorted(h) for h in hits]

    # -- one-shot stacked serving (fallback) --------------------------------

    @spans.traced("fleet.oneshot")
    def _oneshot_query(self, rows: List[np.ndarray], eps: float,
                       dead_ix: Tuple[int, ...],
                       capacity: Optional[int]) -> List[List[int]]:
        """ONE stacked device query through ``merge_flats`` +
        ``fleet_range_query`` on the fleet's device — one pivot launch and
        one survivor launch, but only flat-net pivot/ring bounds prune (no
        frontier rounds)."""
        from repro_torch.core.distributed import fleet_range_query, \
            merge_flats
        flats = [self.shards[w].flat if self.shards.get(w) is not None
                 else None for w in self.workers]
        # the merged fleet arrays only change on resize, so reuse them
        # (and their device copy) across queries instead of re-stacking and
        # re-uploading the whole fleet per call
        if self._merged is not None and self._merged[0] == dead_ix:
            merged = self._merged[1]
        else:
            alive = [f for i, f in enumerate(flats) if i not in dead_ix]
            merged = merge_flats(alive) if len(alive) > 1 else None
            self._merged = (dead_ix, merged)
        hits: List[set] = [set() for _ in rows]
        from repro_torch.kernels.dispatch import pad_ragged_rows
        qb, q_lens = pad_ragged_rows(rows)
        res, stats = fleet_range_query(
            flats, qb, eps, dead=dead_ix, stacked=True, merged=merged,
            capacity=capacity, device=self.device,
            lb_cascade=self.lb_cascade,
            q_lens=None if (q_lens == qb.shape[1]).all()
            else q_lens.astype(np.int32))
        self._note_stats(stats)
        with spans.span("fleet.map_hits"):
            for i, w in enumerate(self.workers):
                if res[i] is None:
                    continue
                gids = self.shards[w].gids
                for qi in range(len(rows)):
                    hits[qi].update(
                        gids[np.flatnonzero(res[i][qi])].tolist())
            return [sorted(h) for h in hits]

    def _note_stats(self, stats: Sequence[Optional[dict]]) -> None:
        """Accumulate device-path evaluation totals (merged fleet stats are
        shared dicts — counted once, not once per shard)."""
        agg = self.device_stats
        seen_merged = False
        for st in stats:
            if st is None:
                continue
            if st.get("merged"):
                if seen_merged:
                    continue
                seen_merged = True
                agg["pivot_evals"] += st["fleet_pivot_evals"]
                agg["member_evals"] += st["fleet_member_evals"]
                agg["fused_pruned"] += st.get("fleet_fused_pruned", 0)
                agg["lb_rows"] += st.get("fleet_lb_rows", 0)
                agg["lb_pruned"] += st.get("fleet_lb_pruned", 0)
                agg["total_evals"] += st["fleet_total_evals"]
            else:
                agg["pivot_evals"] += st["pivot_evals"]
                agg["member_evals"] += st["member_evals"]
                agg["fused_pruned"] += st.get("fused_pruned", 0)
                agg["lb_rows"] += st.get("lb_rows", 0)
                agg["lb_pruned"] += st.get("lb_pruned", 0)
                agg["total_evals"] += st["total_evals"]
        agg["device_queries"] += 1

    # -- accounting ---------------------------------------------------------

    def eval_count(self) -> Dict[str, int]:
        """Host-side counter totals by bucket: ``query`` (host-mode range
        queries) and ``build`` (construction + resharding).  Retired shards'
        counts are retained, so both buckets are monotone across resizes;
        device-path evaluations are tracked in :attr:`device_stats`."""
        out = dict(self._retired)
        for s in self.shards.values():
            if s is None:
                continue
            out["query"] += s.net.counter.count
            out["build"] += s.net.counter.build_count
        return out
