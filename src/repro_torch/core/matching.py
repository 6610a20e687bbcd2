"""The 5-step subsequence matching framework (paper §7).

  1. partition each database sequence into windows of length l = lambda/2;
  2. build the index (reference net / cover tree / MV / linear scan);
  3. extract query segments of lengths l-lambda0 .. l+lambda0;
  4. range-query every segment against the window index;
  5. generate candidate supersequence pairs around each (segment, window)
     hit and verify them.

Query types (paper §3.2):
  I   range:   all similar pairs (|SX|,|SQ| >= lambda, ||SX|-|SQ|| <= lambda0,
               delta <= eps) within the step-5 candidate envelope;
  II  longest: maximize |SQ| via consecutive-window chaining (§7);
  III nearest: minimize delta via binary search on eps over segment hits.

Distance requirements are enforced per the paper: consistency for the
filter (any registered alignment distance), metricity additionally for the
indexed path — DTW routes to the linear-scan filter automatically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import _deprecation, batch_engine
from repro_torch.core import segmentation as seg
from repro_torch.core.counter import CountedDistance
from repro_torch.distances import base as dist_base
from repro_torch.distances import np_backend


@dataclasses.dataclass(frozen=True)
class MatchPair:
    seq_id: int
    x_start: int
    x_len: int
    q_start: int
    q_len: int
    distance: float

    def key(self) -> Tuple[int, int, int, int, int]:
        return (self.seq_id, self.x_start, self.x_len, self.q_start, self.q_len)


@dataclasses.dataclass(frozen=True)
class SegmentHit:
    """Step-4 output: query segment matched to a database window."""
    segment: seg.Segment
    window_idx: int
    window: seg.Window
    distance: float


class LinearScanIndex:
    """Counted linear scan over all windows — the naive baseline, and the
    only legal path for consistent-but-non-metric distances (DTW, §5)."""

    def __init__(self, dist: Union[str, dist_base.Distance],
                 data: np.ndarray, *,
                 counter: Optional[CountedDistance] = None):
        dist = dist_base.resolve(dist)
        self.dist = dist
        self.counter = counter or CountedDistance(self.dist, data)
        self.data = self.counter.data

    def build(self):
        return self

    def range_query(self, q, eps, q_len=None, *,
                    lb_cascade=False) -> List[int]:
        return batch_engine.drive(self.range_query_plan(eps), self.counter,
                                  q, q_len, eps=eps, lb_cascade=lb_cascade)

    def range_query_plan(self, eps: float) -> batch_engine.Plan:
        """Single verdict frontier over the whole database."""
        ds = yield batch_engine.Frontier(np.arange(len(self.data)),
                                         batch_engine.VERDICT)
        return sorted(int(i) for i in np.nonzero(np.asarray(ds) <= eps)[0])


@dataclasses.dataclass(frozen=True)
class _IndexTuning:
    """Config-shaped view over the matcher's index knobs, so the registry's
    per-kind ``tuning`` mapping is the single source of constructor kwargs
    for both the matcher and the facade."""
    eps_prime: float
    num_max: Optional[int]
    tight_bounds: bool
    mv_refs: int


class SubsequenceMatcher:
    """The 5-step pipeline.  Deprecated as a *direct* public entry point
    since v0.1 — build through the facade instead::

        repro_torch.retrieval.Retriever.build(
            RetrievalConfig(dist, lam=..., lambda0=...), seqs)

    The facade delegates here, so behavior and counts are identical; this
    constructor shim will be removed in v0.2."""

    def __init__(self, dist: Union[str, dist_base.Distance], lam: int,
                 lambda0: int = 1, *,
                 index: str = "refnet", eps_prime: float = 1.0,
                 num_max: Optional[int] = None, tight_bounds: bool = False,
                 mv_refs: int = 5, backend: str = "kernel",
                 lb_cascade=False, batched: bool = True,
                 bulk_build: bool = True, device=None):
        _deprecation.warn_legacy("SubsequenceMatcher")
        from repro_torch.retrieval import registry as retrieval_registry
        self.dist = dist_base.require_consistent(dist)
        self.index_spec = retrieval_registry.resolve_index(index)
        if self.index_spec.requires_metric:
            dist_base.require_metric(self.dist)
        self.lam = lam
        self.lambda0 = lambda0
        self.l = seg.window_length(lam)
        self.index_kind = index
        self.backend = backend
        self.device = device
        self.lb_cascade = lb_cascade
        self.batched = batched  # False = legacy per-segment host traversal
        self.bulk_build = bulk_build
        # registry tuning: constructor kwargs are derived from one
        # config-shaped view, the same mapping the facade uses
        self.index_kwargs: Dict = dict(self.index_spec.tuning(
            _IndexTuning(eps_prime=eps_prime, num_max=num_max,
                         tight_bounds=tight_bounds, mv_refs=mv_refs)))
        self.seqs: List[np.ndarray] = []
        self.windows: Optional[np.ndarray] = None
        self.meta: List[seg.Window] = []
        self.index = None
        self.engine: Optional[batch_engine.BatchEngine] = None
        self._verify_batch = None

    # -- steps 1-2 (offline) -------------------------------------------------

    def build(self, seqs: Sequence[np.ndarray]) -> "SubsequenceMatcher":
        """Steps 1-2: window the sequences and build the index.

        The metric hierarchies (refnet / covertree) are bulk-loaded through
        the frontier engine (``build_batched`` — cohorts of concurrent
        insert plans, one merged dispatch per descent level); construction
        cost lands in the counter's ``build`` bucket, so ``eval_count`` /
        ``dispatch_count`` report query work only.
        """
        self.seqs = [np.asarray(x) for x in seqs]
        self.windows, self.meta = seg.partition_windows(self.seqs, self.lam)
        counter = CountedDistance(self.dist, self.windows,
                                  backend=self.backend,
                                  device=self.device)
        index = self.index_spec.factory(self.dist, self.windows,
                                        counter=counter, **self.index_kwargs)
        if self.index_spec.bulk and self.bulk_build:
            self.index = index.build_batched()
        else:
            self.index = index.build()
        self.engine = batch_engine.BatchEngine(self.index.counter,
                                               lb_cascade=self.lb_cascade)
        # step 5 verifies on the host numpy wavefront, as in the reference
        self._verify_batch = np_backend.batch_for(self.dist.name)
        self._flat = None
        self._flat_level = None
        return self

    def flat_net(self, pivot_level: Optional[int] = None):
        """Device-side view of the freshly built net (cached).

        Hands the bulk-built reference net straight to
        ``core.distributed.device_range_query``: ``flatten_net`` reuses the
        net's stored link distances and one stacked dispatch for the rest,
        so no second pair-at-a-time host pass happens here."""
        if self.index_kind not in ("refnet", "covertree"):
            raise ValueError(
                "only the metric hierarchies (refnet, covertree) flatten "
                "to a FlatNet")
        if self._flat is None or self._flat_level != pivot_level:
            from repro_torch.core.distributed import flatten_net
            self._flat = flatten_net(self.index, pivot_level)
            self._flat_level = pivot_level
        return self._flat

    @property
    def eval_count(self) -> int:
        return self.index.counter.count

    @property
    def dispatch_count(self) -> int:
        return self.index.counter.dispatches

    def reset_counter(self) -> None:
        self.index.counter.reset()

    # -- steps 3-4 (online filter) --------------------------------------------

    def segment_hits(self, Q: np.ndarray, eps: float) -> List[SegmentHit]:
        """Step 4: range-query every segment against the window index.

        Batched mode drives ALL segments — every length bucket at once —
        through one frontier-engine run: each merged round is one packed
        ``Distance.batch`` dispatch (``kernels/dispatch.py`` bucket-sorts
        the rows device-side) instead of one per round per bucket.  Hit
        sets and exact-eval counts are identical to the legacy per-segment
        loop (property-tested in tests/test_batch_engine.py).
        """
        Q = np.asarray(Q)
        hits: List[SegmentHit] = []
        buckets = seg.query_segments(Q, self.lam, self.lambda0)
        if self.batched:
            rows: List[np.ndarray] = []
            segs_all: List[seg.Segment] = []
            for ln, (arr, segs) in buckets.items():
                rows.extend(np.asarray(a) for a in arr)
                segs_all.extend(segs)
            plans = [self.index.range_query_plan(eps) for _ in rows]
            per_seg = self.engine.run(plans, rows, eps) if plans else []
            for s, wins in zip(segs_all, per_seg):
                for w in wins:
                    hits.append(SegmentHit(
                        segment=s, window_idx=int(w), window=self.meta[w],
                        distance=math.nan))
            return hits
        for ln, (arr, segs) in buckets.items():
            # lint: allow[dispatch-in-loop] -- legacy batched=False path kept as the sequential parity reference for the engine tests
            per_seg = [self.index.range_query(
                a, eps, q_len=ln, lb_cascade=self.lb_cascade)
                for a in arr]
            for s, wins in zip(segs, per_seg):
                for w in wins:
                    hits.append(SegmentHit(
                        segment=s, window_idx=int(w), window=self.meta[w],
                        distance=math.nan))
        return hits

    # -- step 5: candidate generation + verification ---------------------------

    def _candidates_for_hit(self, Q: np.ndarray, hit: SegmentHit
                            ) -> List[Tuple[int, int, int, int, int]]:
        """Candidate (seq_id, xs, xe, qs, qe) around one hit (paper §7)."""
        l, lam, l0 = self.l, self.lam, self.lambda0
        a = hit.segment.start
        b = hit.segment.start + hit.segment.length  # exclusive end
        c = hit.window.start
        X = self.seqs[hit.window.seq_id]
        nQ, nX = len(Q), len(X)
        out = []
        for qs in range(max(0, a - l - l0), a + 1):
            for qe in range(b, min(nQ, b + l + l0) + 1):
                qlen = qe - qs
                if qlen < lam:
                    continue
                for xs in range(max(0, c - l), c + 1):
                    for xe in range(c + l, min(nX, c + lam) + 1):
                        xlen = xe - xs
                        if xlen < lam or abs(xlen - qlen) > l0:
                            continue
                        out.append((hit.window.seq_id, xs, xe, qs, qe))
        return out

    def _verify(self, Q: np.ndarray, cands: Sequence[Tuple[int, int, int, int, int]]
                ) -> List[MatchPair]:
        """Batched distance verification of candidate pairs."""
        if not cands:
            return []
        Lx = max(xe - xs for _, xs, xe, _, _ in cands)
        Lq = max(qe - qs for _, _, _, qs, qe in cands)
        is_str = self.dist.string
        shp = (len(cands), Lx) if is_str else (len(cands), Lx) + self.seqs[0].shape[1:]
        xs_arr = np.zeros(shp, self.seqs[0].dtype)
        shq = (len(cands), Lq) if is_str else (len(cands), Lq) + self.seqs[0].shape[1:]
        qs_arr = np.zeros(shq, Q.dtype)
        lx = np.zeros(len(cands), np.int64)
        lq = np.zeros(len(cands), np.int64)
        for i, (sid, x0, x1, q0, q1) in enumerate(cands):
            xs_arr[i, : x1 - x0] = self.seqs[sid][x0:x1]
            qs_arr[i, : q1 - q0] = Q[q0:q1]
            lx[i] = x1 - x0
            lq[i] = q1 - q0
        ds = np.asarray(self._verify_batch(qs_arr, xs_arr, lq, lx))
        return [MatchPair(sid, x0, x1 - x0, q0, q1 - q0, float(d))
                for (sid, x0, x1, q0, q1), d in zip(cands, ds)]

    # -- query type I -----------------------------------------------------------

    def query_range(self, Q: np.ndarray, eps: float) -> List[MatchPair]:
        Q = np.asarray(Q)
        hits = self.segment_hits(Q, eps)
        cands = sorted({c for h in hits for c in self._candidates_for_hit(Q, h)})
        verified = self._verify(Q, cands)
        return [m for m in verified if m.distance <= eps]

    # -- query type II ----------------------------------------------------------

    def _chains(self, hits: List[SegmentHit]) -> List[List[SegmentHit]]:
        """Concatenate consecutive-window hits (paper §7 type II step 2)."""
        by_next: Dict[Tuple[int, int, int], List[SegmentHit]] = {}
        for h in hits:
            key = (h.window.seq_id, h.window.start,
                   h.segment.start)
            by_next.setdefault(key[:2], []).append(h)
        # DP over hits: chain[h] = longest chain ending at h
        hits_sorted = sorted(
            hits, key=lambda h: (h.window.seq_id, h.window.start,
                                 h.segment.start))
        best: Dict[int, Tuple[int, Optional[int]]] = {}
        for i, h in enumerate(hits_sorted):
            best[i] = (1, None)
            for j in range(i):
                g = hits_sorted[j]
                if g.window.seq_id != h.window.seq_id:
                    continue
                if h.window.start != g.window.start + self.l:
                    continue
                step = g.segment.start + g.segment.length
                if abs(h.segment.start - step) > self.lambda0:
                    continue
                if best[j][0] + 1 > best[i][0]:
                    best[i] = (best[j][0] + 1, j)
        chains = []
        for i in sorted(best, key=lambda i: -best[i][0]):
            chain = []
            k: Optional[int] = i
            while k is not None:
                chain.append(hits_sorted[k])
                k = best[k][1]
            chains.append(list(reversed(chain)))
        return chains

    def query_longest(self, Q: np.ndarray, eps: float) -> Optional[MatchPair]:
        """Type II: maximize |SQ| s.t. delta <= eps, |SX| >= lambda,
        ||SX|-|SQ|| <= lambda0.

        Verification starts from the longest concatenated chain (§7); a
        chain that fails to verify (e.g. one spurious window hit extended it
        past the true match) backtracks into its two trimmed subchains, so
        the search remains complete over chain sub-spans.
        """
        Q = np.asarray(Q)
        hits = self.segment_hits(Q, eps)
        if not hits:
            return None
        best: Optional[MatchPair] = None
        worklist = list(self._chains(hits))
        seen_spans = set()
        while worklist:
            # longest potential first
            worklist.sort(key=self._chain_potential, reverse=True)
            chain = worklist.pop(0)
            span = (chain[0].window.seq_id,
                    chain[0].window.start, chain[-1].window.start,
                    chain[0].segment.start,
                    chain[-1].segment.start + chain[-1].segment.length)
            if span in seen_spans:
                continue
            seen_spans.add(span)
            if best is not None and self._chain_potential(chain) <= best.q_len:
                break  # nothing left can beat the incumbent
            verified = [m for m in self._verify(
                Q, self._chain_candidates(Q, chain))
                if m.distance <= eps and m.q_len >= self.lam]
            if verified:
                m = max(verified, key=lambda m: m.q_len)
                if best is None or m.q_len > best.q_len:
                    best = m
            if len(chain) > 1:
                worklist.append(chain[1:])
                worklist.append(chain[:-1])
        return best

    def _chain_potential(self, chain) -> int:
        span_q = chain[-1].segment.start + chain[-1].segment.length \
            - chain[0].segment.start
        return span_q + 2 * (self.l + self.lambda0)

    def _chain_candidates(self, Q, chain) -> List[Tuple[int, int, int, int, int]]:
        """Supersequences around a chain: the concatenated span extended by
        up to lambda/2 (+lambda0 on the query side) on each side — the
        (k+2)*lambda/2 bound of §7."""
        l, l0, lam = self.l, self.lambda0, self.lam
        sid = chain[0].window.seq_id
        X = self.seqs[sid]
        c0 = chain[0].window.start
        c1 = chain[-1].window.start + l
        a0 = chain[0].segment.start
        a1 = chain[-1].segment.start + chain[-1].segment.length
        nQ, nX = len(Q), len(X)
        out = []
        for xs in range(max(0, c0 - l), c0 + 1):
            for xe in range(c1, min(nX, c1 + l) + 1):
                if xe - xs < lam:
                    continue
                for qs in range(max(0, a0 - l - l0), a0 + 1):
                    for qe in range(a1, min(nQ, a1 + l + l0) + 1):
                        if qe - qs < lam or abs((xe - xs) - (qe - qs)) > l0:
                            continue
                        out.append((sid, xs, xe, qs, qe))
        return out

    # -- query type III -----------------------------------------------------------

    def query_nearest(self, Q: np.ndarray, eps_max: float, *,
                      tol: float = 1e-2, eps_inc: Optional[float] = None
                      ) -> Optional[MatchPair]:
        """Type III: minimize delta(SX, SQ) (binary search on eps, §7)."""
        Q = np.asarray(Q)
        lo_e, hi_e = 0.0, float(eps_max)
        if not self.segment_hits(Q, hi_e):
            return None
        # smallest eps with at least one segment hit
        while hi_e - lo_e > tol:
            mid = 0.5 * (lo_e + hi_e)
            if self.segment_hits(Q, mid):
                hi_e = mid
            else:
                lo_e = mid
        eps = hi_e
        inc = eps_inc if eps_inc is not None else max(tol, 0.25 * max(eps, tol))
        best: Optional[MatchPair] = None
        while best is None and eps <= eps_max + 1e-9:
            hits = self.segment_hits(Q, eps)
            cands = sorted({c for h in hits
                            for c in self._candidates_for_hit(Q, h)})
            verified = [m for m in self._verify(Q, cands)
                        if m.q_len >= self.lam and m.x_len >= self.lam]
            if verified:
                cand_best = min(verified, key=lambda m: m.distance)
                # by consistency the optimum's own segments hit at eps >=
                # its distance; accept once the verified optimum is within
                # the current search radius
                if cand_best.distance <= eps + tol:
                    best = cand_best
                    break
            eps += inc
        return best


# -- brute force gold standards (tests & paper-claims validation) -------------

def brute_force_range(dist: dist_base.Distance, Q, seqs, lam, lambda0, eps,
                      x_len_exact: Optional[int] = None) -> List[MatchPair]:
    """All pairs with |SX|,|SQ| >= lambda, ||SX|-|SQ|| <= lambda0,
    delta <= eps.  Exponential-ish; only for tiny inputs."""
    batch = np_backend.batch_for(dist.name)
    Q = np.asarray(Q)
    out = []
    for sid, X in enumerate(seqs):
        X = np.asarray(X)
        for xs in range(len(X)):
            for xe in range(xs + lam, len(X) + 1):
                if x_len_exact and xe - xs != x_len_exact:
                    continue
                for qs in range(len(Q)):
                    for qe in range(qs + lam, len(Q) + 1):
                        if abs((xe - xs) - (qe - qs)) > lambda0:
                            continue
                        # lint: allow[dispatch-in-loop,acct-raw-kernel-call] -- brute-force oracle: deliberately unindexed and uncounted (the gold standard the counted paths are tested against)
                        d = float(batch(Q[None, qs:qe], X[None, xs:xe])[0])
                        if d <= eps:
                            out.append(MatchPair(sid, xs, xe - xs, qs,
                                                 qe - qs, d))
    return out


def brute_force_longest(dist, Q, seqs, lam, lambda0, eps) -> Optional[MatchPair]:
    pairs = brute_force_range(dist, Q, seqs, lam, lambda0, eps)
    return max(pairs, key=lambda m: m.q_len) if pairs else None


def brute_force_nearest(dist, Q, seqs, lam, lambda0) -> Optional[MatchPair]:
    pairs = brute_force_range(dist, Q, seqs, lam, lambda0, float("inf"))
    return min(pairs, key=lambda m: m.distance) if pairs else None
