"""Batched frontier-expansion engine for the step-4 hot path.

The paper's range queries (Algorithm 3 and both baselines) are naturally
round-structured: each round the index knows a *frontier* — the set of
still-undecided candidates whose distances it needs next — and nothing
about round k+1 depends on anything but the distances returned for round k.
Pair-at-a-time host traversal throws that structure away; this module keeps
it.

Indexes describe a range query as a **plan**: a generator that

* yields :class:`Frontier` batches of candidate window indices,
* receives the corresponding ``(m,)`` float32 distances back via ``send``,
* and returns the sorted hit list via ``StopIteration.value``.

Two drivers consume plans:

* :func:`drive` — sequential host mode, one dispatch per frontier.  Used by
  every index's classic ``range_query``; evaluation order and counts are
  bit-identical to the historical pair/level-at-a-time path.
* :class:`BatchEngine` — runs *many* concurrent plans (ALL query segments
  across every length bucket, §5: there are only ``2*lambda0 + 1`` of
  them) in lockstep rounds, folding every plan's current frontier into
  **one** ``Distance.batch`` dispatch per round.  Rows carry their own
  lengths, so the packed ragged-bucket kernel dispatcher
  (``kernels/dispatch.py``) serves a whole round in one device call —
  ``CountedDistance(backend="kernel")`` included, with fused ε-pruning for
  verdict-only rows.

Frontiers carry a ``kind``:

* ``EXACT``   — the plan consumes the distance *value* (e.g. a reference
  whose distance feeds Lemma-4 bound propagation); always evaluated.
* ``VERDICT`` — the plan only consumes the ``<= eps`` verdict (leaf
  membership checks, linear-scan rows, MV survivors).  With the LB cascade
  enabled, a cheap provable lower bound (``distances/bounds.py``) runs
  first and candidates with ``lb > eps`` skip the exact O(l^2) DP entirely;
  the bound value is returned in place of the distance, which preserves the
  verdict because ``lb <= delta``.  With the cascade off (default), engine
  results — hit sets AND exact-evaluation counts — are identical to host
  mode.

Frontiers also carry an accounting ``bucket`` (``counter.QUERY`` /
``counter.BUILD``): construction plans (``ReferenceNet.insert_plan``) charge
the counter's build bucket so query-time pruning ratios stay clean.

Plans are not restricted to query-vs-window work.  ``BatchEngine.run``
accepts either a ``(n_plans, l[, d])`` array of query rows *or* a 1-D
integer vector of **data indices** — the pairwise (node-vs-node) mode used
by bulk construction, where plan ``i``'s left-hand side is
``counter.data[queries[i]]``.  Everything else (round merging, one dispatch
per round, per-plan send) is identical.

A third driver, :class:`FleetBatchEngine`, extends the round merge *across
shards*: every alive shard of the elastic fleet contributes its own plans
(over its own shard-local database), and each merged round is still ONE
evaluator call — the round-based fleet serving path (`launch/elastic.py`,
``mode="rounds"``) that keeps the frontier's pruning while paying device
dispatches per round, not per shard per query per round.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Generator, List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.counter import BUILD, QUERY, CountedDistance
from repro_torch.distances import bounds

EXACT = "exact"
VERDICT = "verdict"

#: yields Frontier, receives (m,) float32 distances, returns the plan's
#: result (sorted hit list for queries, an InsertOutcome for construction)
Plan = Generator


@dataclasses.dataclass
class Frontier:
    """One round of undecided candidates of a single frontier plan."""
    idxs: np.ndarray
    kind: str = EXACT
    bucket: str = QUERY     # counter accounting bucket (QUERY / BUILD)

    def __post_init__(self):
        self.idxs = np.asarray(self.idxs, np.int64)


def drive(plan: Plan, counter: CountedDistance, q: np.ndarray,
          q_len: Optional[int] = None, *, eps: Optional[float] = None,
          lb_cascade=False):
    """Sequential host-mode driver: one backend dispatch per frontier.

    ``lb_cascade`` is a tier (``"off" | "endpoint" | "envelope"``; legacy
    booleans map to off/endpoint).  With a tier active, VERDICT frontiers
    route through the counter's staged cascade — pruned candidates answer
    with their (verdict-preserving) lower bound and skip the exact DP.
    """
    tier = bounds.normalize_tier(lb_cascade)
    q = np.asarray(q)
    qlen = len(q) if q_len is None else int(q_len)
    try:
        fr = next(plan)
        while True:
            idxs = fr.idxs
            if tier != "off" and eps is not None and fr.kind == VERDICT:
                qs = np.repeat(q[None, :qlen], idxs.size, 0)
                ds = counter.eval_stacked(qs, idxs, qlen, bucket=fr.bucket,
                                          eps=eps, lb_tier=tier)
            else:
                ds = counter.eval(q, idxs, qlen, bucket=fr.bucket)
            fr = plan.send(ds)
    except StopIteration as stop:
        return stop.value if stop.value is not None else []


class BatchEngine:
    """Run many concurrent range-query plans, one dispatch per round.

    Plans of EVERY length bucket run together (pass a list of ragged query
    rows): each merged round is a single packed ``Distance.batch`` dispatch
    regardless of how many segments, buckets, levels, or candidate lists
    contributed to it — per-row lengths ride through the counter into the
    packed kernel dispatcher.  Uniform-length calls behave exactly as the
    historical per-bucket engine (same counts, same dispatch sequence).
    """

    def __init__(self, counter: CountedDistance, *, lb_cascade=False):
        self.counter = counter
        #: cascade tier ("off" | "endpoint" | "envelope"); legacy booleans
        #: normalize to off/endpoint
        self.lb_cascade = bounds.normalize_tier(lb_cascade)
        self.rounds = 0  # merged frontier rounds (diagnostics / benchmarks)

    def run(self, plans: Sequence[Plan], queries, eps: float,
            q_len: Optional[int] = None) -> List[List[int]]:
        """Drive ``plans[i]`` with query row ``queries[i]``; returns each
        plan's result.  Hit sets and exact-eval counts match sequential host
        mode.

        ``queries`` may instead be a 1-D integer vector of indices into
        ``counter.data`` — the pairwise (node-vs-node) mode: plan ``i``'s
        left-hand rows are gathered from the indexed database itself, which
        is how bulk construction drives cohorts of concurrent insert plans.

        ``queries`` may also be a *list* of rows with differing lengths —
        the packed ragged-bucket mode: plans from every length bucket run
        in lockstep, and each merged round is still ONE backend dispatch
        (rows carry their own lengths through the packed dispatcher), so
        dispatches scale with rounds, not rounds x buckets.
        """
        qlens: Optional[np.ndarray] = None  # per-plan lengths (packed mode)
        if not isinstance(queries, np.ndarray) and q_len is None:
            from repro_torch.kernels.dispatch import pad_ragged_rows
            rows = [np.asarray(q) for q in queries]
            if len({len(r) for r in rows}) > 1:
                queries, qlens = pad_ragged_rows(rows)
            else:
                queries = np.stack(rows) if rows \
                    else np.zeros((0, 0), np.float32)
        queries = np.asarray(queries)
        pair_mode = queries.ndim == 1 and queries.dtype.kind in "iu"
        assert len(plans) == len(queries), "one query row per plan"
        if qlens is not None:
            qlen = None
        elif q_len is not None:
            qlen = int(q_len)
        elif pair_mode:
            qlen = self.counter.data.shape[1]
        else:
            qlen = queries.shape[1]

        def qrows(row_ids: np.ndarray) -> np.ndarray:
            rows = self.counter.data[queries[row_ids]] if pair_mode \
                else queries[row_ids]
            return rows if qlen is None else rows[:, :qlen]

        def row_lens(row_ids: np.ndarray):
            return qlen if qlens is None else qlens[row_ids]

        results: List[Optional[List[int]]] = [None] * len(plans)

        state = {}
        for i, p in enumerate(plans):
            try:
                state[i] = next(p)
            except StopIteration as stop:
                results[i] = stop.value if stop.value is not None else []

        while state:
            order = sorted(state)
            sizes = [state[i].idxs.size for i in order]
            cand = np.concatenate([state[i].idxs for i in order]) \
                if sizes else np.zeros((0,), np.int64)
            rows = np.concatenate(
                [np.full(m, i, np.int64) for i, m in zip(order, sizes)]) \
                if sizes else np.zeros((0,), np.int64)
            verdict = np.concatenate(
                [np.full(m, state[i].kind == VERDICT)
                 for i, m in zip(order, sizes)]) \
                if sizes else np.zeros((0,), bool)
            # a merged round is charged to BUILD only when every contributing
            # frontier is construction work (one call site never mixes them)
            bucket = BUILD if all(state[i].bucket == BUILD for i in order) \
                else QUERY

            tier = bounds.normalize_tier(self.lb_cascade)
            if tier != "off" and verdict.any():
                # staged cascade INSIDE the round: per-row ε carries the
                # query ε on verdict rows and +inf on value-consuming EXACT
                # rows (they opt out of every bound and of fused masking);
                # the counter runs tier-0 / envelope bounds and compacts
                # only the survivors into the single exact dispatch.
                feps = np.where(verdict, np.float32(eps),
                                np.float32(np.inf))
                ds = self.counter.eval_stacked(
                    qrows(rows), cand, row_lens(rows),
                    bucket=bucket, eps=feps, lb_tier=tier)
            elif cand.size:
                # the ONE exact dispatch of this round — every plan, every
                # length bucket.  On a fused backend, verdict-only rows
                # carry the query ε (their values come back verdict-masked),
                # value-consuming EXACT rows opt out via +inf.
                feps = None
                if self.counter.fused:
                    feps = np.where(verdict, np.float32(eps),
                                    np.float32(np.inf))
                ds = self.counter.eval_stacked(
                    qrows(rows), cand, row_lens(rows),
                    bucket=bucket, eps=feps)
            else:
                ds = np.zeros(0, np.float32)
            self.rounds += 1

            new_state = {}
            off = 0
            for i, m in zip(order, sizes):
                try:
                    new_state[i] = plans[i].send(ds[off:off + m])
                except StopIteration as stop:
                    results[i] = stop.value if stop.value is not None else []
                off += m
            state = new_state
        return results  # type: ignore[return-value]


@dataclasses.dataclass
class ShardPlans:
    """One shard's contribution to a cross-shard frontier run.

    ``plans[i]`` is a range-query plan over this shard's *local* database
    (frontier idxs index ``data``); ``queries`` holds one padded query row
    per plan with ``q_lens`` giving the actual lengths (ragged batches share
    one padded width across the whole fleet).  ``shard`` is the provenance
    id (the fleet worker slot) that rides every evaluated row into the
    packed dispatcher's per-shard accounting.  ``lb`` optionally overrides
    the engine-wide envelope hook for this group's rows — the serve layer
    uses it so requests admitted before and after a fleet swap each screen
    against the envelopes of the fleet that admitted them."""
    shard: int
    data: np.ndarray                # (rows, l[, d]) shard-local windows
    plans: Sequence[Plan]
    queries: np.ndarray             # (n_plans, W[, d]) padded query rows
    q_lens: np.ndarray              # (n_plans,) actual query lengths
    lb: Optional[object] = None     # per-group envelope hook (else engine's)


@dataclasses.dataclass
class _Admitted:
    """One admitted batch of a cross-shard run: its groups, its ε, and the
    per-group/per-plan result slots still being filled."""
    groups: List[ShardPlans]
    eps: float
    results: List[List[Optional[List[int]]]]
    live: int = 0                   # plans not yet run to StopIteration


class FleetBatchEngine:
    """Cross-shard frontier merge: one evaluator call per merged round.

    :class:`BatchEngine` merges concurrent plans over ONE database;
    this engine merges plans over MANY shard-local databases — the
    round-based fleet serving path.  Each round it concatenates every
    alive plan's frontier (survivors only — plans that finished, and dead
    workers' plans that were never admitted, simply contribute no rows),
    gathers candidate windows from each plan's own shard, and issues ONE
    ``evaluate`` call spanning all shards and all length buckets.  On a
    fused backend, VERDICT rows carry their batch's ε (pruned candidates
    never have distances materialized — the kernel returns verdict-masked
    sentinels), EXACT rows opt out via ``+inf``, exactly as in
    :class:`BatchEngine`.

    The engine is **incremental**: :meth:`admit` joins a batch of plans
    (its own ε, its own shard groups) to the shared cadence at the next
    round boundary, :meth:`step` advances every in-flight plan by ONE
    merged round, and finished batches retire their rows immediately —
    this is the substrate of the continuous-batching serve layer
    (the serve layer, not yet ported), where requests from different callers
    arrive asynchronously and still share packed dispatches.
    :meth:`run` (admit once, step until drained) preserves the historical
    one-shot contract bit for bit: with a single admitted batch the merged
    row order, frontier sequence, and evaluation counts are identical.

    Evaluation accounting is the caller's: the engine tallies
    ``exact_evals`` / ``verdict_evals`` (requested rows only — backend
    padding never reaches it), per-shard row provenance in ``shard_rows``,
    and the fused-prune certificate count, and the elastic layer folds
    those into ``ElasticIndex.device_stats`` — never into the shards' host
    counters, so the ``{query, build}`` buckets stay host-path currency.
    Frontier sequences are identical to driving each plan sequentially, so
    total evaluations match the host per-shard loop row for row.
    """

    def __init__(self, evaluate, *, fused: bool = False, lb=None):
        #: ``evaluate(xs, ys, lx, ly, eps_rows, shard_ids) -> (dists,
        #: n_pruned)`` — one backend call per merged round
        self.evaluate = evaluate
        self.fused = fused
        #: optional envelope-cascade hook ``lb(shard, idxs, q, q_len) ->
        #: (m,) bounds`` over a shard's PRECOMPUTED per-window envelopes
        #: (``FlatNet.envelopes``).  VERDICT rows with ``lb > eps`` answer
        #: with the bound and never enter the merged evaluate call.
        self.lb = lb
        self.rounds = 0
        self.exact_evals = 0
        self.verdict_evals = 0
        self.fused_pruned = 0
        self.lb_rows = 0
        self.lb_pruned = 0
        self.shard_rows: Dict[int, int] = {}
        self._next_bid = 0
        self._admitted: Dict[int, _Admitted] = {}
        self._state: Dict[tuple, Frontier] = {}   # (bid, g, i) -> frontier

    # -- incremental API (continuous batching) ------------------------------

    def admit(self, groups: Sequence[ShardPlans], eps: float) -> int:
        """Join a batch of plans to the shared cadence; returns its id.

        Plans are primed here (their first frontier is produced), so the
        batch's round-1 rows merge into the very next :meth:`step` — new
        requests join at the round boundary, no drain/restart."""
        bid = self._next_bid
        self._next_bid += 1
        batch = _Admitted(list(groups), float(eps),
                          [[None] * len(g.plans) for g in groups])
        self._admitted[bid] = batch
        for g, grp in enumerate(batch.groups):
            for i, p in enumerate(grp.plans):
                try:
                    self._state[(bid, g, i)] = next(p)
                    batch.live += 1
                except StopIteration as stop:
                    batch.results[g][i] = stop.value \
                        if stop.value is not None else []
        return bid

    @property
    def active(self) -> bool:
        """True while any admitted plan still has frontiers to evaluate."""
        return bool(self._state)

    def batches_in_flight(self) -> Set[int]:
        """Batch ids that would contribute rows to the next round."""
        return {k[0] for k in self._state}

    def is_finished(self, bid: int) -> bool:
        return bid in self._admitted and self._admitted[bid].live == 0

    def results(self, bid: int) -> List[List[List[int]]]:
        """Pop a finished batch's per-group, per-plan results."""
        batch = self._admitted[bid]
        if batch.live:
            raise ValueError(f"batch {bid} still has {batch.live} live plans")
        del self._admitted[bid]
        return batch.results  # type: ignore[return-value]

    def step(self, only: Optional[Set[int]] = None) -> List[int]:
        """Advance every in-flight plan (or the ``only`` batch subset) by
        ONE merged round — one evaluator call across all batches, shards,
        and length buckets.  Returns the batch ids that finished."""
        keys = [k for k in sorted(self._state)
                if only is None or k[0] in only]
        if not keys:
            return []

        def _widen(parts):
            # batches admitted at different times pad their query rows
            # independently; harmonize widths before the concat (no-op —
            # and bit-identical — when one batch is in flight, i.e. run())
            W = max(p.shape[1] for p in parts)
            return [p if p.shape[1] == W else
                    np.pad(p, ((0, 0), (0, W - p.shape[1]))
                           + ((0, 0),) * (p.ndim - 2)) for p in parts]

        sizes = [self._state[k].idxs.size for k in keys]
        xs_parts, ys_parts, lx_parts, ly_parts = [], [], [], []
        shard_parts, verdict_parts = [], []
        part_keep, part_lb = [], []  # per-part cascade masks / bounds
        eps_parts = []               # per-row ε (each batch carries its own)
        for k, m in zip(keys, sizes):
            bid, g, i = k
            batch = self._admitted[bid]
            grp = batch.groups[g]
            fr = self._state[k]
            keep = np.ones(m, bool)
            lbv = None
            hook = grp.lb if grp.lb is not None else self.lb
            if hook is not None and fr.kind == VERDICT and m:
                # envelope tier over the shard's precomputed per-window
                # envelopes: pruned rows answer with the bound below
                # and never enter the merged evaluate call
                lbv = np.asarray(
                    hook(grp.shard, fr.idxs, grp.queries[i],
                         int(grp.q_lens[i])), np.float32)
                keep = lbv <= batch.eps
                self.lb_rows += m
                self.lb_pruned += int(m - keep.sum())
            part_keep.append(keep)
            part_lb.append(lbv)
            mk = int(keep.sum())
            xs_parts.append(np.repeat(grp.queries[i][None], mk, 0))
            ys_parts.append(grp.data[fr.idxs[keep]])
            lx_parts.append(np.full(mk, int(grp.q_lens[i]), np.int64))
            ly_parts.append(np.full(mk, grp.data.shape[1], np.int64))
            shard_parts.append(np.full(mk, grp.shard, np.int64))
            verdict_parts.append(np.full(mk, fr.kind == VERDICT))
            eps_parts.append(np.full(
                mk, batch.eps if fr.kind == VERDICT else np.inf, np.float32))
            self.shard_rows[grp.shard] = \
                self.shard_rows.get(grp.shard, 0) + mk
        xs = np.concatenate(_widen(xs_parts))
        ys = np.concatenate(_widen(ys_parts))
        lx = np.concatenate(lx_parts)
        ly = np.concatenate(ly_parts)
        shard_ids = np.concatenate(shard_parts)
        verdict = np.concatenate(verdict_parts)

        if len(xs):
            eps_rows = np.concatenate(eps_parts) if self.fused else None
            ds, n_pruned = self.evaluate(xs, ys, lx, ly, eps_rows,
                                         shard_ids)
            ds = np.asarray(ds, np.float32)
        else:  # every row of the round was envelope-pruned
            ds, n_pruned = np.zeros(0, np.float32), 0
        self.rounds += 1
        self.exact_evals += int((~verdict).sum())
        self.verdict_evals += int(verdict.sum())
        self.fused_pruned += int(n_pruned)

        finished: List[int] = []
        off = 0
        for k, m, keep, lbv in zip(keys, sizes, part_keep, part_lb):
            bid, g, i = k
            batch = self._admitted[bid]
            mk = int(keep.sum())
            out = np.empty(m, np.float32)
            if lbv is not None:
                out[~keep] = lbv[~keep]
            out[keep] = ds[off:off + mk]
            try:
                self._state[k] = batch.groups[g].plans[i].send(out)
            except StopIteration as stop:
                del self._state[k]
                batch.results[g][i] = stop.value \
                    if stop.value is not None else []
                batch.live -= 1
                if batch.live == 0:
                    finished.append(bid)
            off += mk
        return finished

    # -- one-shot contract (admit once, drain) ------------------------------

    def run(self, groups: Sequence[ShardPlans], eps: float
            ) -> List[List[List[int]]]:
        """Drive every group's plans in lockstep to completion; returns
        per-group, per-plan results (shard-local hit lists, same order as
        ``plans``).  Equivalent to ``admit`` + ``step`` until drained —
        with one batch the merged rounds are identical to the historical
        one-shot engine, row for row."""
        bid = self.admit(groups, eps)
        while self._state:
            self.step()
        return self.results(bid)
