"""Continuous-batching retrieval serve engine.

The engine turns the round-based fleet substrate into a front end for
asynchronous traffic.  Requests submitted at any time land in a
:class:`~repro_torch.serve.queue.RequestQueue`; each :meth:`ServeEngine.tick`

1. applies a pending fleet swap (zero-downtime resize) at the round
   boundary,
2. admits queued requests up to ``max_inflight`` — each request becomes
   one :class:`~repro_torch.core.batch_engine.ShardPlans` group per alive
   shard, joined to the shared cadence via
   :meth:`FleetBatchEngine.admit`, and
3. advances EVERY in-flight request's frontier by ONE merged round —
   one packed ``kernels/dispatch.packed_batch`` call across all
   requests, shards, and length buckets (one wavefront launch on the
   ``kernel`` backend) — retiring finished requests' rows immediately.

Admission policy: ``"tick"`` (default) merges newcomers straight into
the next shared round — strictly fewest dispatches; ``"greedy"`` gives
newcomers one dedicated round first when older requests are already
mid-flight, trading an extra dispatch for not making deep-frontier
stragglers gate a newcomer's first rows.

Zero-downtime resize: :meth:`ServeEngine.resize` snapshots the live
fleet (:class:`~repro_torch.serve.snapshot.FleetSnapshotManager` — atomic
write, latest pointer), restores a clone, reshards the CLONE while the
original keeps serving, then swaps at the next round boundary.
In-flight requests captured their shard groups (plans + gids) at admit
time and finish against the old arrays — hit sets are
shard-layout-invariant over the same windows, so exactness holds across
the swap; new admissions serve from the resharded fleet.

Latency accounting rides the request records themselves
(submit/admit/first-dispatch/complete timestamps, rounds carried);
:meth:`ServeEngine.latency_stats` reduces them to p50/p95/p99.  Two
clocks drive the same machinery: :meth:`start`/:meth:`submit` serve
wall-clock traffic on a background thread, :meth:`run_schedule` replays
a deterministic arrival schedule on a virtual clock — the count-strict
serving check of ``chip_smoke.py`` uses the latter.  On the wall clock a
request completes when the round that finishes it has returned (the
clock is read then); on the virtual clock, at its tick's time.

Failures surface, never vanish: an exception on the serving thread (a
tick, or a background resize) fails every queued and in-flight request —
:meth:`Request.result` raises it — stops the loop, and :meth:`close`
re-raises it.
"""

from __future__ import annotations

import dataclasses
import math
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.batch_engine import FleetBatchEngine, ShardPlans
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.snapshot import FleetSnapshotManager

#: admission policies (see the module docstring)
ADMISSION_POLICIES = ("tick", "greedy")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serve-engine knobs (mirrored by ``RetrievalConfig.serve_*``)."""
    eps: float = 1.0                    # default query radius
    max_inflight: int = 32              # in-flight request cap
    admission: str = "tick"             # "tick" | "greedy"
    snapshot_dir: Optional[str] = None  # default: a fresh temp dir
    snapshot_keep: int = 3

    def __post_init__(self):
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1; got {self.max_inflight}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission must be one of {ADMISSION_POLICIES}; "
                f"got {self.admission!r}")


class ServeEngine:
    """Continuous-batching front end over an ElasticIndex fleet."""

    def __init__(self, fleet, config: Optional[ServeConfig] = None, *,
                 clock=time.monotonic):
        self.fleet = fleet
        self.config = config or ServeConfig()
        self.clock = clock
        self.queue = RequestQueue()
        evaluate, fused = fleet._round_evaluator()
        # ONE long-lived engine: the evaluator closes over the distance
        # name + device only (shape-generic), so it keeps serving across
        # fleet swaps (a swapped-in clone lives on the same device)
        self._engine = FleetBatchEngine(evaluate, fused=fused)
        #: bid -> (request, per-group gids captured at admit time)
        self._inflight: Dict[int, Tuple[Request, List[np.ndarray]]] = {}
        self.completed: List[Request] = []
        self.swaps = 0
        self._pending_swap = None
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._snap: Optional[FleetSnapshotManager] = None
        #: the exception that stopped serving (a tick or a background
        #: resize); every pending request fails with it
        self.error: Optional[BaseException] = None
        self._resize_error: Optional[BaseException] = None

    # -- submission ---------------------------------------------------------

    def submit(self, query: np.ndarray, eps: Optional[float] = None, *,
               tag: Optional[object] = None,
               now: Optional[float] = None) -> Request:
        """Enqueue a range query; returns its handle (``req.result()``
        blocks until served when the engine runs on a thread)."""
        if self.error is not None:
            raise RuntimeError("the serve engine failed") from self.error
        return self.queue.submit(
            query, self.config.eps if eps is None else eps, tag=tag,
            now=self.clock() if now is None else now)

    # -- admission + rounds -------------------------------------------------

    def _lb_hook(self, fleet):
        """Envelope-cascade hook over THIS fleet's precomputed per-window
        envelopes (same tier as ``ElasticIndex._round_query``); bound to
        each admitted group so pre- and post-swap requests screen against
        the fleet that admitted them."""
        if fleet.lb_cascade != "envelope":
            return None
        from repro_torch.distances import bounds as dist_bounds
        envs = {}
        for si, w in enumerate(fleet.workers):
            s = fleet.shards.get(w)
            if s is not None and s.flat.envelopes is not None:
                envs[si] = s.flat.envelopes
        if not envs:
            return None
        name = fleet.dist.name

        def hook(shard, idxs, q, q_len):
            e = envs[shard].take(idxs)
            xs = np.repeat(q[None], len(idxs), 0)
            return dist_bounds.lb_envelope_rows(
                name, xs, np.full(len(idxs), q_len, np.int64),
                e.lo, e.hi, e.mass)

        return hook

    def _admit_one(self, req: Request, now: float,
                   virtual: bool) -> Optional[int]:
        fleet = self.fleet
        q = np.asarray(req.query)
        qpad, q_lens = q[None], np.asarray([len(q)], np.int64)
        hook = self._lb_hook(fleet)
        groups: List[ShardPlans] = []
        gids: List[np.ndarray] = []
        for si, w in enumerate(fleet.workers):
            s = fleet.shards.get(w)
            if s is None:
                continue
            groups.append(ShardPlans(
                shard=si, data=s.net.data,
                plans=[s.net.range_query_plan(req.eps)],
                queries=qpad, q_lens=q_lens, lb=hook))
            gids.append(s.gids)
        req.t_admit = now
        bid = self._engine.admit(groups, req.eps)
        self._inflight[bid] = (req, gids)
        if self._engine.is_finished(bid):  # e.g. an empty fleet
            self._finalize(bid, now if virtual else self.clock())
            return None
        return bid

    def _finalize(self, bid: int, now: float) -> Request:
        req, gids = self._inflight.pop(bid)
        per_group = self._engine.results(bid)
        hits = set()
        for g, res in zip(gids, per_group):
            hits.update(int(g[x]) for x in res[0])
        req.finish(sorted(hits), now)
        self.completed.append(req)
        return req

    def _round(self, now: float, virtual: bool,
               only: Optional[Set[int]] = None) -> List[Request]:
        """One merged round over the in-flight set (or the ``only``
        subset); stamps first-dispatch times with ``now``, retires finished
        rows and stamps their requests' completion: ``now`` on the
        ``virtual`` clock, else the clock read once the round returned."""
        parts = self._engine.batches_in_flight()
        if only is not None:
            parts &= only
        for bid in parts:
            req = self._inflight[bid][0]
            req.rounds += 1
            if math.isnan(req.t_first_dispatch):
                req.t_first_dispatch = now
        finished = self._engine.step(only=only)
        t_done = now if virtual else self.clock()
        return [self._finalize(bid, t_done) for bid in finished]

    def tick(self, now: Optional[float] = None) -> List[Request]:
        """One scheduler beat: swap -> admit -> (greedy round) -> shared
        round.  Returns the requests completed this tick."""
        with self._lock:
            virtual = now is not None     # run_schedule's clock
            now = now if virtual else self.clock()
            if self._resize_error is not None:
                raise RuntimeError("a background resize failed") \
                    from self._resize_error
            if self._pending_swap is not None:  # round boundary: safe swap
                self.fleet = self._pending_swap
                self._pending_swap = None
                self.swaps += 1
            had_inflight = bool(self._inflight)
            budget = self.config.max_inflight - len(self._inflight)
            newly: Set[int] = set()
            for req in self.queue.take(max(budget, 0)):
                bid = self._admit_one(req, now, virtual)
                if bid is not None:
                    newly.add(bid)
            done: List[Request] = []
            if self.config.admission == "greedy" and had_inflight and newly:
                # dedicated first round: newcomers dispatch immediately
                # instead of waiting on the shared cadence
                done.extend(self._round(now, virtual, only=newly))
            if self._engine.active:
                done.extend(self._round(now, virtual))
            return done

    # -- zero-downtime resize ----------------------------------------------

    def _snapshot_manager(self) -> FleetSnapshotManager:
        if self._snap is None:
            d = self.config.snapshot_dir or tempfile.mkdtemp(
                prefix="repro-serve-snap-")
            self._snap = FleetSnapshotManager(
                d, keep=self.config.snapshot_keep)
        return self._snap

    def snapshot(self, block: bool = True) -> int:
        """Snapshot the live fleet; returns the snapshot step."""
        with self._lock:
            return self._snapshot_manager().save(self.fleet, block=block)

    def resize(self, workers: Sequence[str], *, block: bool = True) -> None:
        """Reshard with zero downtime: snapshot -> restore a clone ->
        resize the CLONE (the live fleet keeps serving) -> stage the swap
        for the next round boundary.  ``block=False`` runs the rebuild on
        a background thread (the wall-clock serving mode)."""
        workers = list(workers)

        def work():
            snap = self._snapshot_manager()
            with self._lock:
                step = snap.save(self.fleet, block=True)
                dev = self.fleet.device
            clone = snap.restore(step, device=dev)
            clone.resize(workers)           # off the serving path
            with self._lock:
                self._pending_swap = clone

        def background():
            try:
                work()
            except Exception as exc:  # noqa: BLE001 -- surfaced by tick()
                with self._lock:
                    self._resize_error = exc

        if block:
            work()
        else:
            threading.Thread(target=background, daemon=True).start()

    # -- deterministic virtual-clock serving --------------------------------

    def run_schedule(self, queries: Sequence[np.ndarray],
                     arrivals: Sequence[float], *,
                     eps: Optional[float] = None, round_cost: float = 1.0,
                     resize_at: Optional[float] = None,
                     resize_to: Optional[Sequence[str]] = None
                     ) -> List[Request]:
        """Replay an arrival schedule on a virtual clock (deterministic:
        fixed arrivals + fixed ``round_cost`` per merged round -> identical
        admission pattern, dispatch counts, and latency numbers every run).
        Optionally triggers a zero-downtime ``resize(resize_to)`` at
        virtual time ``resize_at``.  Returns requests in submit order."""
        arrivals = np.asarray(arrivals, np.float64)
        assert len(queries) == len(arrivals)
        reqs: List[Request] = []
        i, n = 0, len(queries)
        t = 0.0
        resized = resize_at is None
        while True:
            if not resized and t >= resize_at:
                self.resize(resize_to)
                resized = True
            while i < n and arrivals[i] <= t:
                reqs.append(self.submit(queries[i], eps=eps,
                                        now=float(arrivals[i])))
                i += 1
            before = self._engine.rounds
            self.tick(now=t)
            t += round_cost * max(1, self._engine.rounds - before)
            if self._engine.active or len(self.queue):
                continue
            if i >= n and resized:
                break
            # idle: jump the clock to the next event (arrival or resize)
            pending = [float(arrivals[i])] if i < n else []
            if not resized:
                pending.append(float(resize_at))
            t = max(t, min(pending))
        return reqs

    # -- wall-clock serving -------------------------------------------------

    def start(self) -> "ServeEngine":
        """Serve on a background thread until :meth:`close`."""
        assert self._thread is None, "already started"
        self._stop.clear()

        def loop():
            try:
                while not self._stop.is_set():
                    with self._lock:
                        idle = not (self._engine.active or len(self.queue)
                                    or self._pending_swap is not None
                                    or self._resize_error is not None)
                    if idle:
                        time.sleep(1e-3)
                    else:
                        self.tick()
            except Exception as exc:  # noqa: BLE001 -- the thread's boundary
                self._fail_all(exc)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def _fail_all(self, exc: BaseException) -> None:
        """Serving stopped on ``exc``: fail every in-flight and queued
        request with it (their ``result()`` raises) and keep it."""
        with self._lock:
            self.error = exc
            now = self.clock()
            for req, _ in self._inflight.values():
                req.fail(exc, now)
            self._inflight.clear()
            for req in self.queue.drain():
                req.fail(exc, now)

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the serving thread; ``drain`` serves everything queued or
        in flight first.  Raises if serving failed on the thread."""
        if self._thread is None:
            return
        if drain:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline and self.error is None:
                with self._lock:
                    busy = (self._engine.active or len(self.queue)
                            or self._pending_swap is not None)
                if not busy:
                    break
                time.sleep(1e-3)
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("the serving thread did not stop")
        self._thread = None
        if self.error is not None:
            raise RuntimeError("serving failed on its thread") \
                from self.error

    # -- accounting ---------------------------------------------------------

    def engine_stats(self) -> Dict[str, int]:
        """Shared-cadence totals (merged rounds, eval split, swaps)."""
        e = self._engine
        return {"rounds": e.rounds, "exact_evals": e.exact_evals,
                "verdict_evals": e.verdict_evals,
                "fused_pruned": e.fused_pruned,
                "lb_rows": e.lb_rows, "lb_pruned": e.lb_pruned,
                "submitted": self.queue.submitted,
                "completed": len(self.completed), "swaps": self.swaps}

    def latency_stats(self) -> Dict[str, float]:
        """Per-request latency percentiles over the completed set (clock
        units: seconds in wall-clock mode, virtual time under
        :meth:`run_schedule`)."""
        done = [r for r in self.completed if r.done]
        if not done:
            return {"n": 0}
        lat = np.array([r.latency for r in done], np.float64)
        out = {"n": len(done),
               "p50": float(np.percentile(lat, 50)),
               "p95": float(np.percentile(lat, 95)),
               "p99": float(np.percentile(lat, 99)),
               "mean": float(lat.mean()),
               "mean_rounds": float(np.mean([r.rounds for r in done]))}
        qd = np.array([r.queue_delay for r in done
                       if not math.isnan(r.t_first_dispatch)], np.float64)
        if len(qd):
            out["queue_p50"] = float(np.percentile(qd, 50))
            out["queue_p99"] = float(np.percentile(qd, 99))
        return out
