"""Counted, batched distance evaluation over a window database.

The paper's evaluation currency (§8.2) is the number of *exact* distance
computations relative to a naive linear scan; every index implementation
funnels its evaluations through :class:`CountedDistance` so the counts are
exact and comparable.  Batch-aware accounting separates three quantities:

* ``count``      — exact O(l^2) DP evaluations (the paper's currency);
* ``dispatches`` — Python-level backend invocations.  The frontier engine
  (``core/batch_engine.py``) folds an entire round of candidates — across
  every concurrent query of a length bucket — into **one** dispatch;
* ``lb_count``   — cheap lower-bound evaluations spent by the optional LB
  cascade (never mixed into ``count``, so paper pruning ratios stay
  comparable);
* ``build_count`` / ``build_dispatches`` — the *construction* bucket: every
  evaluation spent building an index is charged here instead of ``count``,
  so query-time pruning ratios start clean without a ``reset()``.

Backends:

* ``numpy``  — the anti-diagonal wavefront in numpy on the host;
* ``torch``  — the registry's ``Distance.batch`` torch wavefront engine on
  the counter's device;
* ``kernel`` — the packed ragged-bucket dispatcher (``kernels/dispatch.py``)
  with fused ε: rows of one dispatch may mix length buckets freely, and an
  optional fused ε threshold returns verdict-preserving masked distances.
  On a CUDA device every dispatch is one launch of the hand-written
  wavefront kernel; on the CPU it runs the kernel's plain torch version.

For the device backends the window table is uploaded once to the counter's
device (and grown by :meth:`CountedDistance.extend`); each round's
candidate windows are gathered there from the index vector, so only the
round's query rows and indices cross the bus.  ``data`` stays the host
numpy view that index code reads.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.distances import base as dist_base
from repro_torch.distances import bounds
from repro_torch.distances import np_backend

BACKENDS = ("numpy", "torch", "kernel")

#: accounting buckets — query-time (the paper's currency) vs construction
QUERY = "query"
BUILD = "build"


def _resolve_backend(dist: dist_base.Distance, backend: str,
                     device: torch.device) -> Callable:
    """A ``(xs, ys, lx, ly) -> (B,) np.ndarray`` batch function; ``ys`` may
    be a numpy array or a tensor on ``device``."""
    if backend == "numpy":
        try:
            return np_backend.batch_for(dist.name)
        except KeyError:
            # third-party distance: no hand-written numpy wavefront —
            # fall back to the registry's own torch batch callable (host)
            return _registry_batch(dist, torch.device("cpu"))
    if backend == "torch":
        return _registry_batch(dist, device)
    if backend == "kernel":
        from repro_torch.kernels import dispatch as kernel_dispatch
        from repro_torch.kernels import registry as kernel_registry
        if not kernel_registry.has(dist.name):
            # third-party distance: no kernel — its registry batch runs on
            # the counter's device, where the window table already lives
            return _registry_batch(dist, device)

        def kernel_batch(xs, ys, lx=None, ly=None, eps=None):
            # packed ragged-bucket dispatch: rows may mix length buckets
            # freely (bucket-sorted, padded, ONE kernel call); ``eps``
            # engages the fused ε path — non-hit rows come back as the BIG
            # sentinel, which preserves every <= eps verdict.
            out = kernel_dispatch.packed_batch(dist.name, xs, ys, lx, ly,
                                               eps=eps, device=device)
            return out.dist

        kernel_batch.fused = True  # accepts the fused-ε keyword
        return kernel_batch
    raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")


def _registry_batch(dist: dist_base.Distance, device: torch.device
                    ) -> Callable:
    """Wrap the registry's ``Distance.batch`` (rows padded to one common
    width) as a host-callable batch function on ``device``."""

    def torch_batch(xs, ys, lx=None, ly=None):
        if len(xs) == 0:
            return np.zeros((0,), np.float32)
        xs = device_mod.as_tensor(xs, device)
        ys = device_mod.as_tensor(ys, device)
        L = max(xs.shape[1], ys.shape[1])

        def pad_len(a):
            if a.shape[1] == L:
                return a
            pad = a.new_zeros((a.shape[0], L - a.shape[1]) + a.shape[2:])
            return torch.cat([a, pad], dim=1)

        lx = np.full(len(xs), xs.shape[1]) if lx is None else np.asarray(lx)
        ly = np.full(len(ys), ys.shape[1]) if ly is None else np.asarray(ly)
        out = dist.batch(pad_len(xs), pad_len(ys), lx, ly, device=device)
        return out.cpu().numpy()

    return torch_batch


class CountedDistance:
    """Batched distances from query objects to indexed database windows."""

    def __init__(self, dist: dist_base.Distance, data: np.ndarray, *,
                 backend: str = "kernel", device=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
        self.dist = dist
        self.data = np.asarray(data)
        self.n = len(self.data)
        self.backend = backend
        #: the device the torch / kernel backends evaluate on (None: numpy)
        self.device = None if backend == "numpy" \
            else device_mod.resolve(device)
        #: the window table on ``device`` (device backends only)
        self._data_t = None if self.device is None \
            else torch.as_tensor(self.data).to(self.device)
        self._batch = _resolve_backend(dist, backend, self.device)
        self.count = 0       # exact evaluations (paper currency)
        self.dispatches = 0  # Python-level backend dispatches
        self.lb_count = 0    # cheap lower-bound evaluations (LB cascade)
        self.build_count = 0       # exact evaluations spent on construction
        self.build_dispatches = 0  # backend dispatches spent on construction
        #: per-tier LB accounting: rows a tier was evaluated on / pruned
        self.lb_tier_rows: dict = {}
        self.lb_tier_pruned: dict = {}
        #: lazily-built per-window envelope statistics (boxes + ERP gap
        #: masses) over ``data`` — cached for the plan's lifetime so the
        #: cascade never recomputes O(B*L) row norms per round
        self._env_cache: Optional[bounds.EnvelopeSet] = None

    def reset(self) -> None:
        self.count = 0
        self.dispatches = 0
        self.lb_count = 0
        self.build_count = 0
        self.build_dispatches = 0
        self.lb_tier_rows = {}
        self.lb_tier_pruned = {}

    def extend(self, rows: np.ndarray) -> None:
        """Append windows to the indexed database (accounting untouched).

        Existing row indices stay valid — new windows land at the end — so
        an index built over the old database can keep serving while fresh
        content is bulk-loaded on top.  Callers holding a reference to
        ``.data`` must re-read it after this call."""
        rows = np.asarray(rows)
        if len(rows) == 0:
            return
        rows = rows.astype(self.data.dtype)
        self.data = np.concatenate([self.data, rows])
        self.n = len(self.data)
        if self._data_t is not None:
            self._data_t = torch.cat(
                [self._data_t, torch.as_tensor(rows).to(self.device)])
        if self._env_cache is not None:  # incremental envelope refresh
            self._env_cache.extend(bounds.build_envelopes(rows))

    def envelopes(self) -> bounds.EnvelopeSet:
        """Per-window envelope statistics over ``data`` (cached).

        Built in ONE stacked vectorized pass on first use; ``extend``
        refreshes it incrementally, so the cascade's per-candidate gap
        masses and boxes are gathered (``take``), never recomputed."""
        if self._env_cache is None:
            self._env_cache = bounds.build_envelopes(self.data)
        return self._env_cache

    def _windows(self, idxs: np.ndarray):
        """Candidate windows ``data[idxs]``: gathered on the device for the
        device backends (only the index vector crosses the bus), on the
        host for numpy."""
        if self._data_t is None:
            return self.data[idxs]
        return self._data_t[torch.as_tensor(idxs).to(self.device)]

    def eval(self, q: np.ndarray, idxs: Sequence[int],
             q_len: Optional[int] = None, *,
             bucket: str = QUERY) -> np.ndarray:
        """delta(q, data[i]) for i in idxs. Counts len(idxs) evaluations."""
        idxs = np.asarray(idxs, np.int64)
        if idxs.size == 0:
            return np.zeros((0,), np.float32)
        q = np.asarray(q)
        qlen = len(q) if q_len is None else q_len
        qs = np.repeat(q[None, :qlen], idxs.size, 0)
        return self.eval_stacked(qs, idxs, qlen, bucket=bucket)

    @property
    def fused(self) -> bool:
        """Whether the backend supports fused ε-pruning (kernel backend)."""
        return getattr(self._batch, "fused", False)

    def eval_stacked(self, qs: np.ndarray, idxs: Sequence[int],
                     q_len=None, *, bucket: str = QUERY,
                     eps=None, lb_tier=None) -> np.ndarray:
        """delta(qs[i], data[idxs[i]]) row-wise in ONE backend dispatch.

        ``qs`` holds one (possibly repeated) query row per candidate — the
        frontier engine concatenates every concurrent query's round into a
        single call here, so dispatches scale with rounds, not candidates.
        ``q_len`` may be a scalar or a per-row vector: the packed engine
        mixes every length bucket of a round into one dispatch.  ``eps``
        (scalar or per-row; +inf rows opt out) engages the backend's fused
        ε path when it has one — returned values keep every ``<= eps``
        verdict (non-hits come back as a quasi-infinity), and accounting is
        unchanged: each requested row is one exact evaluation, padding rows
        are never counted.

        ``lb_tier`` stages the LB cascade *inside* the round: finite-ε rows
        run the tier-0 endpoint bounds (host numpy), ``"envelope"``
        additionally runs the envelope bound on the survivors, and only the
        remaining rows are compacted into the (single) exact dispatch —
        pruned rows come back as their bound value, which preserves every
        ``<= eps`` verdict because ``lb <= delta``.
        """
        idxs = np.asarray(idxs, np.int64)
        if idxs.size == 0:
            return np.zeros((0,), np.float32)
        qs = np.asarray(qs)
        L = self.data.shape[1]
        if q_len is None:
            lx = np.full(idxs.size, qs.shape[1], np.int64)
        elif np.ndim(q_len) == 0:
            lx = np.full(idxs.size, int(q_len), np.int64)
        else:
            lx = np.asarray(q_len, np.int64)
        if not self.dist.variable_length and (lx != L).any():
            bad = int(lx[(lx != L).argmax()])
            raise ValueError(
                f"{self.dist.name} requires equal lengths ({bad} != {L})")
        # Rectangular (Lx != Ly) and ragged tiles: all backends take
        # per-row length vectors.
        xs = qs[:, :int(lx.max())]
        ly = np.full(idxs.size, L, np.int64)

        tier = bounds.normalize_tier(lb_tier)
        if tier != "off" and eps is not None:
            return self._cascade_stacked(xs, idxs, lx, ly, eps, tier,
                                         bucket)

        self._charge(bucket, int(idxs.size))
        ys = self._windows(idxs)
        if eps is not None and self.fused:
            return np.asarray(self._batch(xs, ys, lx, ly, eps=eps),
                              np.float32)
        return np.asarray(self._batch(xs, ys, lx, ly), np.float32)

    def _charge(self, bucket: str, rows: int) -> None:
        if bucket == BUILD:
            self.build_count += rows
            self.build_dispatches += 1
        else:
            self.count += rows
            self.dispatches += 1

    def _note_lb(self, tier: str, rows: int, pruned: int) -> None:
        self.lb_count += int(rows)
        self.lb_tier_rows[tier] = self.lb_tier_rows.get(tier, 0) + int(rows)
        self.lb_tier_pruned[tier] = \
            self.lb_tier_pruned.get(tier, 0) + int(pruned)

    def _cascade_stacked(self, xs, idxs, lx, ly, eps, tier: str,
                         bucket: str) -> np.ndarray:
        """Tiered LB staging of one round: endpoint -> envelope -> exact.

        Rows with ``eps = +inf`` (value-consuming EXACT frontiers) opt out
        of every bound and always reach the exact dispatch; all counters see
        requested rows only.  The bounds run on the host over the numpy
        window table; the exact survivors are gathered where the backend
        evaluates.
        """
        if tier == "envelope" and self.backend == "kernel":
            raise NotImplementedError(
                "lb_cascade='envelope' under the kernel backend runs the "
                "device envelope kernel, which is not ported yet "
                "(ROADMAP.md Queue 1: device LB-envelope tier)")
        B = idxs.size
        ys = self.data[idxs]
        eps_v = np.broadcast_to(
            np.asarray(eps, np.float32), (B,)).astype(np.float32)
        eligible = np.isfinite(eps_v)
        alive = eligible.copy()
        lbs = np.zeros(B, np.float32)

        lb_fn = self.dist.lower_bound
        if lb_fn is not None and eligible.any():
            r = np.flatnonzero(eligible)
            kw = {}
            if self.dist.name == "erp":
                # gap masses gathered from the cached envelope statistics,
                # not recomputed O(B*L) per round
                kw["y_mass"] = self.envelopes().mass[idxs[r]]
            lb0 = np.asarray(
                lb_fn(xs[r], ys[r], lx[r], ly[r], **kw), np.float32)
            pruned0 = lb0 > eps_v[r]
            lbs[r] = np.maximum(lbs[r], lb0)
            alive[r[pruned0]] = False
            self._note_lb("endpoint", r.size, int(pruned0.sum()))

        if tier == "envelope" and alive.any() and \
                self.dist.envelope_bound is not None:
            r = np.flatnonzero(alive)
            y_env = self.envelopes().take(idxs[r])
            lb1 = np.asarray(self.dist.envelope_bound(
                xs[r], ys[r], lx[r], ly[r], y_env=y_env), np.float32)
            pruned1 = lb1 > eps_v[r]
            lbs[r] = np.maximum(lbs[r], lb1)
            alive[r[pruned1]] = False
            self._note_lb("envelope", r.size, int(pruned1.sum()))

        out = lbs  # pruned rows answer with their bound (verdict-preserving)
        exact = ~eligible | alive
        n_exact = int(exact.sum())
        if n_exact:
            self._charge(bucket, n_exact)
            ys_exact = self._windows(idxs[exact])
            if self.fused:
                vals = self._batch(xs[exact], ys_exact, lx[exact],
                                   ly[exact], eps=eps_v[exact])
            else:
                vals = self._batch(xs[exact], ys_exact, lx[exact],
                                   ly[exact])
            out[exact] = np.asarray(vals, np.float32)
        return out

    def lower_bounds(self, qs: np.ndarray, idxs: Sequence[int],
                     q_len=None) -> Optional[np.ndarray]:
        """Cheap row-wise lower bounds, or None when the distance has none.

        ``q_len`` scalar or per-row (packed rounds mix length buckets).
        Counted in ``lb_count`` only — never in ``count``."""
        lb = self.dist.lower_bound
        if lb is None:
            return None
        idxs = np.asarray(idxs, np.int64)
        if idxs.size == 0:
            return np.zeros((0,), np.float32)
        qs = np.asarray(qs)
        ys = self.data[idxs]
        if q_len is None:
            lx = np.full(len(ys), qs.shape[1], np.int64)
        elif np.ndim(q_len) == 0:
            lx = np.full(len(ys), int(q_len), np.int64)
        else:
            lx = np.asarray(q_len, np.int64)
        self._note_lb("endpoint", int(idxs.size), 0)
        ly = np.full(len(ys), ys.shape[1])
        kw = {}
        if self.dist.name == "erp":
            # gap masses are cached per candidate id for the plan's
            # lifetime — not recomputed O(B*L) on every round
            kw["y_mass"] = self.envelopes().mass[idxs]
        return np.asarray(
            lb(qs[:, :int(lx.max())], ys, lx, ly, **kw), np.float32)

    def pairwise(self, i: int, idxs: Sequence[int], *,
                 bucket: str = BUILD) -> np.ndarray:
        """delta(data[i], data[j]) for j in idxs (node-vs-node; charged to
        the ``build`` bucket by default — its callers are constructors)."""
        return self.eval(self.data[i], idxs, bucket=bucket)

    def eval_pairs(self, lefts: Sequence[int], rights: Sequence[int], *,
                   bucket: str = BUILD) -> np.ndarray:
        """delta(data[lefts[i]], data[rights[i]]) row-wise in ONE dispatch.

        The pairwise (node-vs-node) analogue of :meth:`eval_stacked`; used
        by bulk construction (cohort conflict arbitration)."""
        lefts = np.asarray(lefts, np.int64)
        if lefts.size == 0:
            return np.zeros((0,), np.float32)
        return self.eval_stacked(self.data[lefts], rights, bucket=bucket)
