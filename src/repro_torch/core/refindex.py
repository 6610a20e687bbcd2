"""Reference-based indexing baseline (Venkateswaran et al., VLDB'06).

The paper's other comparison point: pick ``k`` references, precompute the
full (k x N) distance table, and prune with the triangle inequality
|d(Q, r) - d(r, X)| > eps  =>  d(Q, X) > eps.  Space is O(kN) — the paper's
point is that the reference net achieves better pruning with O(N) space.

Reference selection uses the Maximum Variance heuristic (paper §8.2 uses MV
because Maximum Pruning needs a training query set): greedily pick the
candidate whose distance vector over a sample has maximal variance,
discounting redundancy with already-picked references.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core import batch_engine
from repro_torch.core.counter import CountedDistance
from repro_torch.distances import base as dist_base


class MVReferenceIndex:
    def __init__(self, dist, data: np.ndarray, *,
                 n_refs: int = 5, sample: int = 256, seed: int = 0,
                 counter: Optional[CountedDistance] = None):
        # registry name or Distance instance, interchangeably
        self.dist = dist_base.require_metric(dist)
        self.counter = counter or CountedDistance(self.dist, data)
        self.data = self.counter.data
        self.n_refs = n_refs
        self._rng = np.random.default_rng(seed)
        self._sample = sample
        self.refs: List[int] = []
        self.table: Optional[np.ndarray] = None  # (n_refs, N)

    def build(self) -> "MVReferenceIndex":
        """Stacked bulk construction: the candidate-profile and table loops
        are (candidate x sample) and (reference x N) pairwise blocks, each
        assembled in one ``eval_pairs`` dispatch (chunked only to bound the
        wavefront's working set) and charged to the counter's ``build``
        bucket — query-time accounting starts at zero without a reset."""
        N = len(self.data)
        cand = self._rng.choice(N, size=min(4 * self.n_refs, N), replace=False)
        samp = self._rng.choice(N, size=min(self._sample, N), replace=False)
        # variance of each candidate's distance profile over the sample
        profiles = self._pair_block(cand, samp)
        scores = profiles.var(axis=1)
        order = np.argsort(scores)[::-1]
        picked: List[int] = []
        for o in order:
            if len(picked) >= self.n_refs:
                break
            # redundancy discount: skip candidates highly correlated with
            # an already-picked reference profile
            if any(np.corrcoef(profiles[o], profiles[p])[0, 1] > 0.95
                   for p in picked):
                continue
            picked.append(int(o))
        while len(picked) < self.n_refs:
            extra = [int(o) for o in order if int(o) not in picked]
            if not extra:
                break
            picked.append(extra[0])
        self.refs = [int(cand[p]) for p in picked]
        self.table = self._pair_block(np.asarray(self.refs, np.int64),
                                      np.arange(N, dtype=np.int64))
        return self

    #: rows per build dispatch — bounds the numpy wavefront's (B, Lx, Ly)
    #: cost tensor while keeping dispatch counts O(k*N / cap), not O(k)
    _CHUNK_ROWS = 1 << 17

    def _pair_block(self, lefts: np.ndarray, rights: np.ndarray
                    ) -> np.ndarray:
        """(len(lefts), len(rights)) distance block via stacked dispatches."""
        ll = np.repeat(np.asarray(lefts, np.int64), len(rights))
        rr = np.tile(np.asarray(rights, np.int64), len(lefts))
        out = np.empty(ll.size, np.float32)
        for s in range(0, ll.size, self._CHUNK_ROWS):
            e = min(s + self._CHUNK_ROWS, ll.size)
            out[s:e] = self.counter.eval_pairs(ll[s:e], rr[s:e])
        return out.reshape(len(lefts), len(rights))

    def range_query(self, q: np.ndarray, eps: float,
                    q_len: Optional[int] = None, *,
                    lb_cascade=False) -> List[int]:
        return batch_engine.drive(self.range_query_plan(eps), self.counter,
                                  q, q_len, eps=eps, lb_cascade=lb_cascade)

    def range_query_plan(self, eps: float) -> batch_engine.Plan:
        """Two-frontier plan: reference row (exact, feeds the triangle-
        inequality table pruning), then the survivors (verdict only)."""
        assert self.table is not None, "call build() first"
        dq = yield batch_engine.Frontier(np.asarray(self.refs, np.int64),
                                         batch_engine.EXACT)  # k evals
        lower = np.max(np.abs(np.asarray(dq)[:, None] - self.table), axis=0)
        surv = np.nonzero(lower <= eps)[0]
        if surv.size == 0:
            return []
        dd = yield batch_engine.Frontier(surv, batch_engine.VERDICT)
        return sorted(int(i) for i in surv[np.asarray(dd) <= eps])

    def stats(self) -> dict:
        return {
            "n_objects": len(self.data),
            "n_refs": self.n_refs,
            "table_entries": int(self.table.size) if self.table is not None else 0,
            "size_bytes": 4 * int(self.table.size) if self.table is not None else 0,
        }
