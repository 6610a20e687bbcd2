"""The Reference Net (paper §6 + Appendix A) — host-mode implementation.

A hierarchical metric index with levels ``i = 0 .. r-1``:

* level radius ``eps_i = eps' * 2**i``;
* *inclusive*: every reference at level i-1 is within ``eps_i`` of at least
  one level-i reference (it has >= 1 parent);
* *exclusive*: two references at the same level i are > ``eps_i`` apart;
* a node may have **multiple parents** (the net/tree distinction of Fig. 2),
  capped at ``num_max`` to keep space linear;
* the bottom layer holds *all* database objects: an object within ``eps_0``
  of some level-0 reference is stored as a plain member of that reference's
  list, otherwise it becomes a level-0 (or higher) reference itself;
* each reference is stored once, at its highest level (paper §6), and each
  list link records the (conceptual) level at which it was formed — in the
  paper a reference has a separate list per level it appears at; recording
  the attach level preserves those per-level radii in flattened storage.

Range queries implement Algorithm 3 / Lemma 4 as *bound propagation*: every
processed reference R with known d = delta(Q, R) contributes, through each
of its list links, an interval for the child and for the child's whole
derived subtree:

    d(Q, c)        in  [d - r_link,        d + r_link]
    d(Q, subtree)  in  [d - r_link - sr_c, d + r_link + sr_c]

where, in **faithful** mode (the paper's Lemma 4), ``r_link = eps_i`` of the
attach level and ``sr_c = eps_{level(c)+1}``; in **tight** mode (a
beyond-paper refinement, cf. M-tree) ``r_link`` is the exact stored link
distance and ``sr_c`` the exact maintained subtree radius.  With multiple
parents the intervals *intersect* — this is precisely the Fig. 2 advantage:
every additional parent is another chance to decide a child for free.
Children are resolved lazily (objects at the very end, expandable references
just before their own level), so every parent that gets processed
contributes its bound before any distance evaluation is spent.

All distance evaluations go through :class:`CountedDistance`, so pruning
ratios reported by the benchmarks are exact evaluation counts.

Construction mirrors querying: Alg. 1's widened descent is a frontier
*plan* (:meth:`ReferenceNet.insert_plan`) that yields per-level candidate
batches and returns a pure :class:`InsertOutcome`; ``insert`` drives one
plan sequentially (classic counts), while :meth:`ReferenceNet.build_batched`
drives whole cohorts of plans through the batch engine and commits them
after order-rank conflict arbitration — same invariants and hit sets, far
fewer backend dispatches.  Build-time evaluations are charged to the
counter's ``build`` bucket, never to the paper's query currency.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch import spans
from repro_torch.core import batch_engine
from repro_torch.core.counter import CountedDistance
from repro_torch.distances import base as dist_base

OBJ = -1  # pseudo-level of plain (non-reference) objects
INF = float("inf")


@dataclasses.dataclass
class InsertOutcome:
    """Result of an :meth:`ReferenceNet.insert_plan` descent.

    A pure description of *where* object ``idx`` lands — the plan never
    mutates the net, so many plans can run concurrently against one
    snapshot and be committed (or re-planned) afterwards by the bulk
    loader's arbitration."""
    idx: int
    new_top: int                 # required root level (>= top at plan time)
    target_level: int            # stored level of the new node (OBJ = member)
    attach_level: int            # conceptual level of the new links
    owners: Dict[int, float]     # candidate parents -> exact distance


@dataclasses.dataclass
class Node:
    idx: int                   # row in the data array
    level: int                 # highest level at which this node is a reference
    children: List[int]        # node idxs appearing in my list
    child_dist: List[float]    # exact delta(me, child) per link
    child_level: List[int]     # conceptual level the link was formed at
    parents: List[int]         # up-links (multi-parent; len <= num_max)
    sub_radius: float = 0.0    # exact derived-subtree radius (maintained)


class ReferenceNet:
    """Host-mode reference net over a fixed-length window database.

    Args:
      tight_bounds: False = paper-faithful Lemma-4 radii (eps powers);
        True = exact link distances / subtree radii (beyond-paper, strictly
        tighter, same O(n) space).
    """

    def __init__(self, dist, data: np.ndarray, *,
                 eps_prime: float = 1.0, num_max: Optional[int] = None,
                 tight_bounds: bool = False,
                 counter: Optional[CountedDistance] = None):
        # registry name or Distance instance, interchangeably
        self.dist = dist_base.require_metric(dist)
        self.eps_prime = float(eps_prime)
        self.num_max = num_max
        self.tight_bounds = tight_bounds
        self.counter = counter or CountedDistance(self.dist, data)
        self.data = self.counter.data
        self.nodes: Dict[int, Node] = {}
        self.root: Optional[int] = None
        self.top_level: int = 0

    # -- state hand-over ----------------------------------------------------

    def to_state(self) -> Dict[str, object]:
        """The built net as a plain dict of numpy arrays and lists.

        ``root``/``top_level``, the tuning knobs, and per node (in ``idx``
        order): ``idx``, ``level``, ``sub_radius`` (arrays) and the link
        lists ``children``, ``child_dist``, ``child_level``, ``parents``
        (lists of lists, distances kept as Python floats so a round trip
        is exact).  :meth:`from_state` rebuilds the net from it."""
        ids = sorted(self.nodes)
        nodes = [self.nodes[i] for i in ids]
        return {
            "root": self.root, "top_level": self.top_level,
            "eps_prime": self.eps_prime, "num_max": self.num_max,
            "tight_bounds": self.tight_bounds,
            "idx": np.asarray(ids, np.int64),
            "level": np.asarray([n.level for n in nodes], np.int64),
            "sub_radius": np.asarray([n.sub_radius for n in nodes],
                                     np.float64),
            "children": [list(n.children) for n in nodes],
            "child_dist": [list(n.child_dist) for n in nodes],
            "child_level": [list(n.child_level) for n in nodes],
            "parents": [list(n.parents) for n in nodes],
        }

    @classmethod
    def from_state(cls, dist, data: np.ndarray, state: Dict[str, object], *,
                   counter: Optional[CountedDistance] = None
                   ) -> "ReferenceNet":
        """Rebuild a net from :meth:`to_state` output with ZERO distance
        evaluations (``data`` must be the window table it was built on)."""
        net = cls(dist, data, eps_prime=state["eps_prime"],
                  num_max=state["num_max"],
                  tight_bounds=bool(state["tight_bounds"]), counter=counter)
        for k, idx in enumerate(np.asarray(state["idx"]).tolist()):
            net.nodes[idx] = Node(
                idx, int(state["level"][k]),
                [int(c) for c in state["children"][k]],
                [float(x) for x in state["child_dist"][k]],
                [int(x) for x in state["child_level"][k]],
                [int(x) for x in state["parents"][k]],
                float(state["sub_radius"][k]))
        net.root = None if state["root"] is None else int(state["root"])
        net.top_level = int(state["top_level"])
        return net

    # -- radii ------------------------------------------------------------

    def eps(self, i: int) -> float:
        """Level radius eps_i = eps' * 2**i  (eps_{OBJ} treated as 0)."""
        if i < 0:
            return 0.0
        return self.eps_prime * (2.0 ** i)

    def _link_radius(self, node: Node, k: int) -> float:
        if self.tight_bounds:
            return node.child_dist[k]
        return self.eps(node.child_level[k])

    def _subtree_radius(self, node: Node) -> float:
        if not node.children:
            return 0.0
        if self.tight_bounds:
            return node.sub_radius
        return self.eps(node.level + 1)

    # -- construction -------------------------------------------------------

    def build(self, order: Optional[Sequence[int]] = None) -> "ReferenceNet":
        """Sequential loader (one insert-plan descent per object); see
        :meth:`build_batched` for the cohort bulk loader."""
        idxs = range(len(self.data)) if order is None else order
        for i in idxs:
            self.insert(i)
        return self

    def extend_data(self, rows: np.ndarray) -> List[int]:
        """Append fresh windows to the net's database without touching the
        built structure; returns their new row indices.

        The rows are *not* inserted — feed the returned indices to
        :meth:`build_batched` (``order=new_ids``) to bulk-load them through
        the cohort pipeline against the existing net.  This is the elastic
        layer's reshard-in path: a shard that gains windows extends and
        bulk-loads instead of rebuilding from scratch."""
        rows = np.asarray(rows)
        base = len(self.counter.data)
        self.counter.extend(rows)
        self.data = self.counter.data
        return list(range(base, base + len(rows)))

    def insert(self, idx: int) -> None:
        """Insert object ``idx``: the sequential ``drive()`` of
        :meth:`insert_plan` — evaluation counts and the resulting structure
        are bit-identical to the historical pair-at-a-time descent."""
        if self.root is None:
            self.root = idx
            self.top_level = 0
            self.nodes[idx] = Node(idx, 0, [], [], [], [])
            return
        out = batch_engine.drive(self.insert_plan(idx), self.counter,
                                 self.data[idx])
        self._apply_insert(out)

    def insert_plan(self, idx: int) -> batch_engine.Plan:
        """Alg. 1's widened descent as a frontier plan (same Frontier/send
        protocol as :meth:`range_query_plan`, build-bucket accounting).

        Yields per-level EXACT frontiers of reference idxs, receives their
        distances to ``data[idx]``, and returns an :class:`InsertOutcome`
        describing where the object lands — without mutating the net, so
        ``build_batched`` can run whole cohorts of these concurrently
        against one snapshot and arbitrate conflicts before committing.
        """
        assert self.root is not None, "seed the net with one insert() first"
        ds = yield batch_engine.Frontier(
            np.asarray([self.root], np.int64), batch_engine.EXACT,
            bucket=batch_engine.BUILD)
        d_root = float(ds[0])
        # the root's level must grow until it covers the new point; recorded
        # in the outcome and applied at commit time
        top = self.top_level
        while d_root > self.eps(top):
            top += 1

        # descend, keeping the *wide* frontier: refs with d <= 2*eps_i; any
        # same-level conflict below is reachable through such ancestors
        # (chain bound: eps_l + sum_{t=l+1..i} eps_t <= 2*eps_i).
        frontier: Dict[int, float] = {self.root: d_root}
        parents_at: Dict[int, Dict[int, float]] = {}
        level = top
        parents_at[level] = {
            n: d for n, d in frontier.items() if d <= self.eps(level)}
        while level > 0:
            cand: Set[int] = set()
            for n in frontier:
                for c in self.nodes[n].children:
                    if c in self.nodes and self.nodes[c].level == level - 1:
                        cand.add(c)
                # a reference conceptually appears at every level below its
                # top; keep it in the running frontier
                cand.add(n)
            cand_new = [c for c in cand if c not in frontier]
            dists: Dict[int, float] = {}
            if cand_new:
                ds = yield batch_engine.Frontier(
                    np.asarray(cand_new, np.int64), batch_engine.EXACT,
                    bucket=batch_engine.BUILD)
                dists.update(zip(cand_new, map(float, ds)))
            dists.update({c: frontier[c] for c in cand if c in frontier})
            level -= 1
            frontier = {c: d for c, d in dists.items()
                        if d <= 2.0 * self.eps(level)}
            parents_at[level] = {
                c: d for c, d in dists.items() if d <= self.eps(level)}
            if not frontier:
                break

        # Alg. 1 "jumps to the lowest possible level": X becomes a reference
        # one level below the lowest covered level m.  Exclusivity at m-1 is
        # guaranteed: any level-(m-1) conflict would have been discovered
        # through the wide frontier.
        m = None
        for l in range(0, top + 1):
            if parents_at.get(l):
                m = l
                break
        assert m is not None, "root must cover the new point after growth"
        if m == 0:
            # within eps_0 of a level-0 reference -> plain object (bottom)
            return InsertOutcome(idx, top, OBJ, 0, parents_at[0])
        return InsertOutcome(idx, top, m - 1, m, parents_at[m])

    def _apply_insert(self, out: InsertOutcome) -> None:
        """Commit a planned insert: grow the root, then attach."""
        while self.top_level < out.new_top:
            self.top_level += 1
            self.nodes[self.root].level = self.top_level
        self._attach(out.idx, out.target_level, out.owners,
                     attach_level=out.attach_level)

    @spans.traced("refnet.build")
    def build_batched(self, order: Optional[Sequence[int]] = None, *,
                      max_cohort: int = 256,
                      engine: Optional["batch_engine.BatchEngine"] = None
                      ) -> "ReferenceNet":
        """Level-synchronous bulk loader: cohorts of concurrent insert plans.

        Each round takes a cohort of not-yet-inserted objects, runs all
        their :meth:`insert_plan` descents against the *current* net through
        the :class:`~repro_torch.core.batch_engine.BatchEngine` (pairwise mode —
        one merged dispatch per descent level instead of one per object per
        level), then commits the outcomes.  Two cohort members that would
        both become references at the same level may violate the exclusive
        property; :meth:`_commit_cohort` detects those pairs with one
        batched dispatch and resolves them by deterministic order-rank
        arbitration — the earlier object in ``order`` wins, the loser is
        re-planned in the next cohort against the updated net (where it
        typically lands *under* the winner).  The result passes
        ``check_invariants()`` and returns identical range-query hit sets
        to a sequentially built net, with far fewer backend dispatches
        (``counter.build_dispatches``; see ``benchmarks/bench_build.py``).

        Cohort sizes double from 4 up to ``max_cohort`` — the early net is
        coarse and conflict-prone, the late net absorbs large cohorts with
        almost no arbitration.
        """
        idxs = list(range(len(self.data))) if order is None else \
            [int(i) for i in order]
        rank = {x: r for r, x in enumerate(idxs)}
        pending = [i for i in idxs if i not in self.nodes]
        if self.root is None and pending:
            self.insert(pending.pop(0))
        eng = engine or batch_engine.BatchEngine(self.counter)
        cohort = 4
        while pending:
            take, pending = pending[:cohort], pending[cohort:]
            plans = [self.insert_plan(i) for i in take]
            outs = eng.run(plans, np.asarray(take, np.int64), eps=0.0)
            deferred = self._commit_cohort(outs, rank)
            pending = deferred + pending
            cohort = min(2 * cohort, max_cohort)
        return self

    def _commit_cohort(self, outs: Sequence[InsertOutcome],
                       rank: Dict[int, int]) -> List[int]:
        """Commit one cohort's outcomes; return the re-plan (loser) idxs.

        Conflicts only arise between two *new* references at the same
        stored level (each plan's wide frontier already rules out conflicts
        with snapshot references), so it suffices to evaluate intra-cohort
        same-level pairs — one batched dispatch — and accept greedily in
        order-rank."""
        outs = sorted(outs, key=lambda o: rank[o.idx])
        groups: Dict[int, List[int]] = {}
        for o in outs:
            if o.target_level >= 0:
                groups.setdefault(o.target_level, []).append(o.idx)
        pairs = [(a, b) for grp in groups.values()
                 for i, a in enumerate(grp) for b in grp[i + 1:]]
        pair_d: Dict[Tuple[int, int], float] = {}
        if pairs:
            ds = self.counter.eval_pairs([a for a, _ in pairs],
                                         [b for _, b in pairs])
            pair_d = {p: float(d) for p, d in zip(pairs, ds)}
        accepted: List[InsertOutcome] = []
        deferred: List[int] = []
        winners_at: Dict[int, List[int]] = {}
        for o in outs:
            if o.target_level >= 0:
                eps_l = self.eps(o.target_level)
                if any(pair_d[(w, o.idx)] <= eps_l
                       for w in winners_at.get(o.target_level, ())):
                    deferred.append(o.idx)
                    continue
                winners_at.setdefault(o.target_level, []).append(o.idx)
            accepted.append(o)
        for o in accepted:
            self._apply_insert(o)
        return deferred

    def _attach(self, idx: int, level: int, owners: Dict[int, float],
                attach_level: int) -> None:
        assert owners, "inclusive property would be violated"
        ranked = sorted(owners.items(), key=lambda kv: kv[1])
        if self.num_max is not None:
            ranked = ranked[: self.num_max]
        node = Node(idx, level, [], [], [], [p for p, _ in ranked])
        self.nodes[idx] = node
        for p, d in ranked:
            pn = self.nodes[p]
            pn.children.append(idx)
            pn.child_dist.append(d)
            pn.child_level.append(attach_level)
            self._grow_radius(p, d)  # node.sub_radius starts at 0

    def _grow_radius(self, p: int, new_r: float) -> None:
        """Propagate an enlarged subtree radius up the parent DAG.

        Iterative (explicit stack): multi-parent DAGs built from large n can
        be deep enough that the recursive form hits Python's recursion
        limit; the <=-check still cuts every already-covered branch."""
        stack = [(p, new_r)]
        while stack:
            x, r = stack.pop()
            xn = self.nodes[x]
            if r <= xn.sub_radius:
                continue
            xn.sub_radius = r
            for gp in xn.parents:
                gpn = self.nodes.get(gp)
                if gpn is None:
                    continue
                k = gpn.children.index(x)
                stack.append((gp, gpn.child_dist[k] + r))

    # -- deletion (Alg. 2) --------------------------------------------------

    def delete(self, idx: int) -> None:
        node = self.nodes.pop(idx)
        if idx == self.root:
            raise NotImplementedError("root deletion requires re-rooting")
        for p in node.parents:
            pn = self.nodes.get(p)
            if pn is not None:
                k = pn.children.index(idx)
                del pn.children[k], pn.child_dist[k], pn.child_level[k]
        # re-home orphaned members of X's list (Alg. 2: if a member still
        # appears in another list we do nothing, else re-insert it)
        orphans = []
        for k, c in enumerate(node.children):
            cn = self.nodes.get(c)
            if cn is None:
                continue
            cn.parents.remove(idx)
            if not cn.parents:
                orphans.append(c)
        for c in orphans:
            cn = self.nodes.pop(c)
            sub = [(g, cn.child_dist[k], cn.child_level[k])
                   for k, g in enumerate(cn.children)]
            self.insert(c)
            new_cn = self.nodes[c]
            for g, gd, gl in sub:
                gn = self.nodes.get(g)
                if gn is not None:
                    new_cn.children.append(g)
                    new_cn.child_dist.append(gd)
                    new_cn.child_level.append(gl)
                    gn.parents.append(c)
                    self._grow_radius(c, gd + gn.sub_radius)

    # -- range query (Alg. 3 as bound propagation) ---------------------------

    def range_query(self, q: np.ndarray, eps: float,
                    q_len: Optional[int] = None, *,
                    lb_cascade=False) -> List[int]:
        """All object idxs X with delta(q, X) <= eps (host-mode driver)."""
        return batch_engine.drive(self.range_query_plan(eps), self.counter,
                                  q, q_len, eps=eps, lb_cascade=lb_cascade)

    def range_query_plan(self, eps: float) -> batch_engine.Plan:
        """Algorithm 3 as a frontier generator (see ``core/batch_engine.py``).

        Yields batches of undecided candidates, receives their distances,
        returns the sorted hit list.  The frontier sequence — and therefore
        the exact-evaluation count — is identical to the classic host path;
        only *who* evaluates a frontier (sequential driver vs the batched
        engine merging many plans per round) changes.
        """
        if self.root is None:
            return []
        known: Dict[int, float] = {}   # exact distances (each counted once)
        lo: Dict[int, float] = {}      # accumulated object lower bounds
        hi: Dict[int, float] = {}      # accumulated object upper bounds
        slo: Dict[int, float] = {}     # subtree lower bounds
        shi: Dict[int, float] = {}     # subtree upper bounds
        closed: Set[int] = set()       # whole-subtree verdict settled
        decided: Set[int] = set()      # object verdict settled
        results: List[int] = []

        def request(idxs, kind):
            # de-dup against known, then yield ONE frontier for the batch
            new = sorted(set(i for i in idxs if i not in known))
            if new:
                ds = yield batch_engine.Frontier(np.asarray(new, np.int64),
                                                 kind)
                known.update(zip(new, map(float, ds)))

        def settle_subtree(n: int, accept: bool) -> None:
            stack = [n]
            while stack:
                x = stack.pop()
                if x in closed:
                    continue
                closed.add(x)
                if x not in decided:
                    decided.add(x)
                    if accept:
                        results.append(x)
                stack.extend(self.nodes[x].children)

        def decide(x: int, inside: bool) -> None:
            if x in decided:
                return
            decided.add(x)
            if inside:
                results.append(x)

        yield from request([self.root], batch_engine.EXACT)
        d_root = known[self.root]
        decide(self.root, d_root <= eps)
        alive: Set[int] = {self.root}
        pending_leaf: Set[int] = set()     # objects awaiting final verdict

        for level in range(self.top_level, -1, -1):
            # evaluate deferred expandable children whose level is reached;
            # exact values feed Lemma-4 bound propagation below
            defer = [c for c in alive
                     if c not in known and c not in closed
                     and self.nodes[c].level == level]
            yield from request(defer, batch_engine.EXACT)
            for c in defer:
                d = known[c]
                decide(c, d <= eps)

            for n in sorted(c for c in alive
                            if self.nodes[c].level == level):
                alive.discard(n)
                if n in closed:
                    continue
                node = self.nodes[n]
                d = known[n]
                sr = self._subtree_radius(node)
                if d + sr <= eps:
                    settle_subtree(n, accept=True)
                    continue
                if d - sr > eps:
                    # n itself was decided exactly; only descendants settle
                    for c in node.children:
                        settle_subtree(c, accept=False)
                    closed.add(n)
                    continue
                for k, c in enumerate(node.children):
                    if c in closed:
                        continue
                    cn = self.nodes.get(c)
                    if cn is None:
                        continue
                    r = self._link_radius(node, k)
                    src = self._subtree_radius(cn)
                    lo[c] = max(lo.get(c, 0.0), d - r)
                    hi[c] = min(hi.get(c, INF), d + r)
                    slo[c] = max(slo.get(c, 0.0), d - r - src)
                    shi[c] = min(shi.get(c, INF), d + r + src)
                    if shi[c] <= eps:
                        settle_subtree(c, accept=True)
                        continue
                    if slo[c] > eps:
                        settle_subtree(c, accept=False)
                        continue
                    if hi[c] <= eps:
                        decide(c, True)
                    elif lo[c] > eps:
                        decide(c, False)
                    if cn.children:
                        alive.add(c)       # expandable: deferred to its level
                    elif c not in decided:
                        pending_leaf.add(c)
                closed.add(n)

        # final object verdicts for leaves no parent managed to decide free;
        # only the <= eps verdict is consumed, so the LB cascade may prune
        rem = [c for c in pending_leaf if c not in decided and c not in closed]
        yield from request(rem, batch_engine.VERDICT)
        for c in rem:
            decide(c, known[c] <= eps)
        return sorted(results)

    def _subtree(self, n: int, include_self: bool = True) -> List[int]:
        out = [n] if include_self else []
        stack = list(self.nodes[n].children)
        seen = set(stack)
        while stack:
            c = stack.pop()
            out.append(c)
            cn = self.nodes.get(c)
            if cn:
                for g in cn.children:
                    if g not in seen:
                        seen.add(g)
                        stack.append(g)
        return out

    # -- invariants & stats (used by tests / benchmarks) ----------------------

    def check_invariants(self) -> None:
        levels: Dict[int, List[int]] = {}
        for n in self.nodes.values():
            levels.setdefault(n.level, []).append(n.idx)
        # exclusive
        for l, members in levels.items():
            if l < 0 or len(members) < 2:
                continue
            eps_l = self.eps(l)
            for a_i, a in enumerate(members):
                rest = members[a_i + 1:]
                if not rest:
                    continue
                ds = np.asarray(self.counter._batch(
                    np.repeat(self.data[a][None], len(rest), 0),
                    self.data[rest]))
                if np.any(ds <= eps_l):
                    bad = rest[int(np.argmax(ds <= eps_l))]
                    raise AssertionError(
                        f"exclusive violated at level {l}: {a} vs {bad}")
        # inclusive + link metadata consistency
        for n in self.nodes.values():
            if n.idx != self.root:
                assert n.parents, f"node {n.idx} has no parent"
                if self.num_max is not None:
                    assert len(n.parents) <= self.num_max
            for k, c in enumerate(n.children):
                cn = self.nodes.get(c)
                if cn is None:
                    continue
                d = float(self.counter._batch(
                    self.data[n.idx][None], self.data[c][None])[0])
                assert abs(d - n.child_dist[k]) <= 1e-3, \
                    f"stored link distance wrong for {n.idx}->{c}"
                assert d <= self.eps(n.child_level[k]) + 1e-4, \
                    f"link {n.idx}->{c} exceeds its attach-level radius"
        # subtree radii are genuine upper bounds
        for n in self.nodes.values():
            sub = self._subtree(n.idx, include_self=False)
            if not sub:
                continue
            ds = np.asarray(self.counter._batch(
                np.repeat(self.data[n.idx][None], len(sub), 0),
                self.data[sub]))
            assert np.all(ds <= n.sub_radius + 1e-3), \
                f"sub_radius understates subtree extent at {n.idx}"
            assert np.all(ds <= self.eps(n.level + 1) + 1e-3), \
                f"Lemma-4 radius violated at {n.idx}"
        # reachability
        reach = set(self._subtree(self.root))
        missing = set(self.nodes) - reach
        assert not missing, f"unreachable nodes: {sorted(missing)[:5]}"

    def stats(self) -> Dict[str, float]:
        n_list_entries = sum(len(n.children) for n in self.nodes.values())
        n_refs = sum(1 for n in self.nodes.values() if n.level >= 0)
        parents = [len(n.parents) for n in self.nodes.values()
                   if n.idx != self.root]
        return {
            "n_objects": len(self.nodes),
            "n_references": n_refs,
            "n_levels": self.top_level + 1,
            "n_list_entries": n_list_entries,
            "avg_parents": float(np.mean(parents)) if parents else 0.0,
            "max_parents": int(np.max(parents)) if parents else 0,
            # per link: child idx (8B) + distance (4B) + level (4B); per node:
            # idx/level/radius/record overhead ~24B
            "size_bytes": 16 * n_list_entries + 24 * len(self.nodes),
        }
