"""Device-mode retrieval: the reference net flattened into dense arrays and
a one-shot batched range query over them (the reference's TPU design,
``src/repro/core/distributed.py``, on the card).

Host mode chases pointers; accelerators want dense batched work.  The net
is flattened at a pivot level m: every reference with level >= m becomes a
*pivot*; every window belongs to exactly one pivot's member list (its
parent chain's level-m ancestor), carrying its exact link distance.  A
batched range query is then:

  1. one wavefront-kernel call: queries x pivots distances  (Q, P);
  2. triangle-inequality verdicts per pivot:
       d + sub_radius <= eps  -> accept all members free,
       d - sub_radius >  eps  -> prune all members free;
  3. per-member ring bound |d(q,pivot) - d(pivot,w)| > eps prunes members
     of undecided pivots elementwise (free — the link distances are dense
     arrays);
  4. survivors are compacted and evaluated in one more kernel call (none
     when nothing survives).

The reference runs 2-4 as jnp ops over the member lists padded to the
widest one, ``(Q, P, M)``, and compacts with a static capacity
(``jnp.nonzero(size=)``), retrying at twice the capacity on overflow.  The
port runs them in the ring filter (``kernels/ring_filter.py``: a CUDA
kernel on the card, its plain torch version on the CPU) over the real
(pivot, member) pairs only, ``Q * Nv`` slots, and compacts to the exact
survivor count, in the same order, after one read of that count; nothing
is retried, and ``stats["capacity"]`` still reports the capacity the
reference's doubling rule ends at, computed from the survivor count.
``stats["filter_slots"]`` counts the slots the filter visited.

A FlatNet holds its member lists as those pairs on the host too
(``mem_pivot``/``mem_id``/``mem_dist``); the reference's padded ``(P, M)``
lists exist only in the snapshot file (``serve/snapshot.py`` converts
them).  The arrays are uploaded to a device once per
FlatNet version and kept there (:meth:`FlatNet.device_arrays`); ``append``
and ``remove`` drop the copy.
The fleet version merges the alive shards' FlatNets (:func:`merge_flats`)
into ONE device query; results are exact unions, since shards partition
the windows.

This one-shot stacked fleet query is the elastic layer's *fallback*
serving mode (``ElasticIndex(..., fleet_mode="oneshot")``): it pays one
pivot launch and at most one survivor launch per batch, but only the flat
pivot/ring bounds prune.  The default fleet path is round-based — shard-
local frontier plans merged per round through the packed fused-ε
dispatcher (``core/batch_engine.FleetBatchEngine`` + ``kernels/dispatch.py``)
— which keeps the reference net's full pruning power (see
``launch/elastic.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import spans
from repro_torch.core import _deprecation
from repro_torch.core.refnet import ReferenceNet
from repro_torch.distances import bounds
from repro_torch.distances import np_backend
from repro_torch.distances._wavefront import sqrt_rn, sum_last
from repro_torch.kernels import registry as kernel_registry
from repro_torch.kernels import ring_filter
from repro_torch.kernels.wavefront import lev_operand


@dataclasses.dataclass
class FlatNet:
    """Flattened (pivot -> members) arrays; the member lists as CSR pairs,
    pivot-major (``mem_pivot`` ascending), each pivot's run in its stored
    order."""
    pivots: np.ndarray          # (P, l[, d]) pivot windows
    pivot_radius: np.ndarray    # (P,) exact derived-subtree radius
    mem_pivot: np.ndarray       # (Nv,) pivot row of each pair
    mem_id: np.ndarray          # (Nv,) window id of each pair
    mem_dist: np.ndarray        # (Nv,) exact delta(pivot, member), f32
    data: np.ndarray            # (N, l[, d]) all windows
    n_pivots: int
    dist_name: str
    pivot_ids: Optional[np.ndarray] = None   # (P,) window id of each pivot
    #: precomputed per-window envelope statistics (boxes + ERP gap masses;
    #: ``distances/bounds.py``), built in ONE stacked pass at flatten time.
    #: Fleet rounds and the device query path gather these instead of
    #: recomputing O(N*L) row reductions per query; None when the distance
    #: has no envelope bound.
    envelopes: Optional[bounds.EnvelopeSet] = None
    #: the arrays on one device: ``(device, {name: tensor})``, dropped by
    #: ``append`` / ``remove`` (see :meth:`device_arrays`)
    _on_device: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)

    def device_arrays(self, dev: torch.device) -> Dict[str, torch.Tensor]:
        """The query operands on ``dev``, uploaded once per FlatNet version
        (``append``/``remove`` drop the copy): pivots, radii (f32), the
        (pivot, member) pairs as they are held (``mem_pivot`` and
        ``mem_id`` int32, ``mem_dist`` f32), the window database and, when
        present, the envelopes.  Token ids go up as the kernel takes them
        (int32, range-checked here), so no query converts or checks them
        again."""
        if self._on_device is not None and self._on_device[0] == dev:
            return self._on_device[1]
        if len(self.data) > np.iinfo(np.int32).max:
            raise ValueError(f"{len(self.data)} windows: the device query "
                             "takes window ids of int32")
        rows = _operand_of(self.dist_name)
        arrs = {"pivots": rows(self.pivots),
                "pradius": torch.as_tensor(
                    np.asarray(self.pivot_radius, np.float32)),
                "mem_pivot": torch.as_tensor(
                    self.mem_pivot.astype(np.int32)),
                "mem_id": torch.as_tensor(self.mem_id.astype(np.int32)),
                "mem_dist": torch.as_tensor(
                    np.asarray(self.mem_dist, np.float32)),
                "data": rows(self.data)}
        if self.envelopes is not None:
            arrs["env_lo"] = torch.as_tensor(self.envelopes.lo)
            arrs["env_hi"] = torch.as_tensor(self.envelopes.hi)
            arrs["env_mass"] = torch.as_tensor(self.envelopes.mass)
        arrs = {k: v.to(dev).contiguous() for k, v in arrs.items()}
        self._on_device = (dev, arrs)
        return arrs

    def append(self, pivot_rows: Sequence[int], member_ids: Sequence[int],
               member_dists: Sequence[float], new_data: Optional[np.ndarray]
               = None) -> "FlatNet":
        """Incrementally attach members (``member_ids[k]`` under pivot row
        ``pivot_rows[k]`` at distance ``member_dists[k]``) in place.

        ``new_data`` extends the window database when the ids are fresh
        (online inserts after flattening); each new pair goes to the end of
        its pivot's run, in input order, and pivot radii grow
        monotonically, so a refreshed net never needs a full re-flatten to
        stay queryable on device.
        """
        self._on_device = None
        if new_data is not None and len(new_data):
            new_data = np.asarray(new_data)
            self.data = np.concatenate([self.data, new_data])
            if self.envelopes is not None:  # incremental envelope refresh
                self.envelopes.extend(bounds.build_envelopes(new_data))
        pivot_rows = np.asarray(pivot_rows, np.int64)
        member_dists = np.asarray(member_dists, np.float32)
        # ``np.insert`` places values at one index in their given order
        at = np.searchsorted(self.mem_pivot, pivot_rows, side="right")
        self.mem_pivot = np.insert(self.mem_pivot, at, pivot_rows)
        self.mem_id = np.insert(self.mem_id, at,
                                np.asarray(member_ids, np.int64))
        self.mem_dist = np.insert(self.mem_dist, at, member_dists)
        np.maximum.at(self.pivot_radius, pivot_rows, member_dists)
        return self

    def remove(self, member_ids: Sequence[int]) -> "FlatNet":
        """Drop windows' pairs in place, keeping the order of the rest —
        zero distance evaluations.

        The elastic layer calls this when rendezvous resharding moves
        windows *out* of a shard: the departed ids can never be reported as
        hits again, while pivot rows stay behind as routing-only ghosts
        (a pivot is just a stored vector, so it keeps partitioning the
        survivors even after its own window left) and ``pivot_radius``
        keeps its monotone upper-bound property untouched.  ``envelopes``
        keep their rows too: a departed id never reappears as a candidate,
        so its (stale) envelope row is simply never gathered again.
        """
        ids = np.asarray(list(member_ids), np.int64)
        if ids.size == 0:
            return self
        self._on_device = None
        keep = ~np.isin(self.mem_id, ids)
        self.mem_pivot = self.mem_pivot[keep]
        self.mem_id = self.mem_id[keep]
        self.mem_dist = self.mem_dist[keep]
        return self


def _operand_of(dist_name: str):
    """Host rows -> host tensor as distance ``dist_name``'s kernel takes
    them: int32 token ids (``ValueError`` outside int32), else as they
    are."""
    if kernel_registry.takes_token_ids(dist_name):
        return lev_operand
    return torch.as_tensor


@spans.traced("refnet.flatten")
def flatten_net(net: ReferenceNet, pivot_level: Optional[int] = None
                ) -> FlatNet:
    """Flatten a host reference net at ``pivot_level`` (default ~sqrt(N)).

    Pivot->member distances come from the net itself where a member is a
    direct child of its pivot (the exact link distance is already stored —
    a bulk- or sequentially-built net hands those over for free); only the
    remaining pairs are evaluated, in a single stacked dispatch through the
    net's counter (``build`` bucket, so the flatten cost is measured on
    whichever backend the counter runs).
    """
    N = len(net.data)
    levels = sorted({n.level for n in net.nodes.values() if n.level >= 0})
    if pivot_level is None:
        # lowest level whose reference count is <= sqrt-ish of N
        target = max(1, int(math.sqrt(N)))
        pivot_level = levels[-1]
        for lv in levels:
            cnt = sum(1 for n in net.nodes.values() if n.level >= lv)
            if cnt <= 4 * target:
                pivot_level = lv
                break
    pivot_ids = [n.idx for n in net.nodes.values() if n.level >= pivot_level]
    pivot_of = {}

    def assign(pid):
        for x in net._subtree(pid, include_self=True):
            node = net.nodes.get(x)
            if x not in pivot_of and (node is None or
                                      node.level < pivot_level or x == pid):
                pivot_of[x] = pid

    for pid in pivot_ids:
        assign(pid)
    members: List[List[int]] = [[] for _ in pivot_ids]
    pidx = {p: i for i, p in enumerate(pivot_ids)}
    for x, p in pivot_of.items():
        members[pidx[p]].append(x)
    P = len(pivot_ids)
    mem_pivot = np.repeat(np.arange(P), [len(ms) for ms in members])
    mem_id = np.asarray([x for ms in members for x in ms], np.int64)
    # reuse stored link distances for direct children (0 for the pivot
    # itself); stack the rest into one batched dispatch (no per-pivot host
    # loop)
    link = [{**dict(zip(net.nodes[p].children, net.nodes[p].child_dist)),
             p: 0.0} for p in pivot_ids]
    stored = [link[i].get(x) for i, ms in enumerate(members) for x in ms]
    mem_dist = np.asarray([0.0 if d is None else d for d in stored],
                          np.float32)
    need = np.asarray([k for k, d in enumerate(stored) if d is None], int)
    if need.size:
        mem_dist[need] = net.counter.eval_pairs(
            np.asarray(pivot_ids)[mem_pivot[need]], mem_id[need])
    radius = np.zeros(P, np.float32)
    np.maximum.at(radius, mem_pivot, mem_dist)
    # one stacked envelope pass over the whole window database (reused by
    # fleet rounds and the device query path instead of per-query rebuilds)
    envs = bounds.build_envelopes(net.data) \
        if net.dist.envelope_bound is not None else None
    return FlatNet(
        pivots=np.asarray(net.data[pivot_ids]),
        pivot_radius=radius,
        mem_pivot=mem_pivot, mem_id=mem_id, mem_dist=mem_dist,
        data=np.asarray(net.data), n_pivots=P, dist_name=net.dist.name,
        pivot_ids=np.asarray(pivot_ids, np.int64),
        envelopes=envs)


def _batch_dist(dist_name: str, qs, xs, device=None):
    """Deprecated since v0.1, removed in v0.2: batched distance lives in
    the kernel registry — call
    ``repro_torch.kernels.registry.get(name).batch(qs, xs)`` (or, from the
    facade, serve through ``repro_torch.retrieval.Retriever``, which never
    needs a raw batched distance).  This wrapper keeps external callers
    working for one release (the warning is suppressed inside
    facade-internal construction, mirroring the legacy-constructor
    shims)."""
    _deprecation.warn_moved("core.distributed._batch_dist",
                            "repro_torch.kernels.registry.get(name).batch")
    return kernel_registry.get(dist_name).batch(qs, xs, device=device).dist


def final_capacity(capacity: int, n_need: int) -> int:
    """The survivor capacity the reference's retry loop ends at: doubled
    from ``capacity`` until it holds ``n_need`` rows."""
    cap = int(capacity)
    while n_need > cap:
        cap *= 2
    return cap


def device_range_query(flat: FlatNet, qs: np.ndarray, eps: float, *,
                       capacity: Optional[int] = None,
                       q_lens: Optional[np.ndarray] = None,
                       lb_cascade="off", device=None
                       ) -> Tuple[np.ndarray, dict]:
    """Batched exact range query on one shard, on ``device`` (default: the
    card).

    Returns (hits (Q, N) bool, stats).  ``capacity`` is the reference's
    static survivor budget (default ``max(64, N // 4) * Q``): survivors are
    compacted to their exact count here, and ``stats["capacity"]`` reports
    the budget the reference's overflow doubling ends at.  ``q_lens``
    gives per-query actual lengths (ragged batches padded to a common
    width — the fleet layer packs every length bucket into one call).

    ``lb_cascade="envelope"`` adds an envelope-bound stage between the ring
    compaction and the exact kernel call, gathering the PRECOMPUTED
    per-window envelopes stored on the FlatNet (``flat.envelopes``): rows
    whose bound already certifies ``> eps`` are compacted away before the
    wavefront runs, and ``member_evals`` counts only the rows that reached
    it (``lb_rows`` / ``lb_pruned`` report the stage itself).  Off by
    default — counts are then identical to the path without the stage.
    """
    dev = device_mod.resolve(device)
    Q = qs.shape[0]
    N = len(flat.data)
    if capacity is None:
        capacity = max(64, N // 4) * Q
    if q_lens is None:
        q_lens = np.full(Q, qs.shape[1], np.int32)
    use_env = bounds.normalize_tier(lb_cascade) == "envelope" \
        and flat.envelopes is not None
    with spans.span("oneshot.upload"):
        arrs = flat.device_arrays(dev)
        qs_t = _operand_of(flat.dist_name)(np.asarray(qs)).to(dev)
        q_lens_t = device_mod.as_tensor(np.asarray(q_lens), dev, torch.int32)
    hits, n_need, n_evals, n_pruned, lb_rows, lb_pruned = _device_query(
        qs_t.contiguous(), q_lens_t.contiguous(), arrs, float(eps),
        flat.dist_name, use_env)
    with spans.span("oneshot.fetch"):
        with spans.span("oneshot.wait"):
            hits = hits.cpu()
            n_pruned = int(n_pruned)
    stats = {"pivot_evals": Q * flat.n_pivots,
             "member_evals": n_evals,
             "fused_pruned": n_pruned,
             "lb_rows": lb_rows,
             "lb_pruned": lb_pruned,
             "capacity": final_capacity(capacity, n_need),
             "total_evals": Q * flat.n_pivots + n_evals,
             "filter_slots": Q * arrs["mem_id"].numel()}
    return hits.numpy(), stats


def _device_query(qs, q_lens, arrs, eps: float, dist_name: str,
                  use_env: bool):
    """The one-shot query on the operands' device: ``(hits (Q, N) bool
    tensor, n_need, member_evals, fused_pruned (a tensor on the device, or
    0), lb_rows, lb_pruned)``.

    One wavefront launch for the ``Q * P`` query-pivot rows (eps = +inf:
    the values feed the ring bounds), the ring filter, and one wavefront
    launch for the survivors when there are any.  The survivor count is
    the one read that blocks (one more with the envelope stage)."""
    pivots, pradius, data = arrs["pivots"], arrs["pradius"], arrs["data"]
    dev = qs.device
    Q = qs.shape[0]
    P = pivots.shape[0]
    N = data.shape[0]
    spec = kernel_registry.get(dist_name)
    # each read that blocks on the card is an ``oneshot.wait`` span inside
    # its phase
    with spans.span("oneshot.pivots"):
        # 1. queries x pivots — value-consuming (feeds the ring bounds)
        qs_rep = qs.repeat_interleave(P, dim=0)
        pv_rep = pivots.repeat((Q,) + (1,) * (pivots.ndim - 1))
        dp = spec.device_call(qs_rep, pv_rep, lx=q_lens.repeat_interleave(P)
                              ).dist.reshape(Q, P)
    with spans.span("oneshot.filter"):
        # 2.-4. pivot verdicts, ring bounds and compaction over the real
        # (pivot, member) pairs; free verdicts go into the hit mask, and a
        # spare byte past it takes the survivors' misses below
        cells = torch.zeros(Q * N + 1, dtype=torch.bool, device=dev)
        hits = cells[:Q * N].view(Q, N)
        ring = ring_filter.ring_filter(
            dp.contiguous(), pradius, arrs["mem_pivot"], arrs["mem_id"],
            arrs["mem_dist"], eps, hits)
        with spans.span("oneshot.wait"):
            n_need = int(ring.n_need)
        rows = ring_filter.survivor_rows(ring, n_need, qs, q_lens, data)
    with spans.span("oneshot.survivors"):
        lb_rows = lb_pruned = 0
        if use_env and n_need:
            # 4b. envelope stage on the compacted survivors: gather the
            # PRECOMPUTED per-window boxes/masses (built once at flatten
            # time) and compact a second time, so only rows the envelope
            # bound cannot certify as > eps reach the exact wavefront.
            # One-direction form of the sound bounds in
            # ``distances/bounds.py::lb_envelope_rows``.
            w_of = rows.w_of
            lb = _envelope_rows(dist_name, rows.xs, rows.q_len,
                                arrs["env_lo"][w_of], arrs["env_hi"][w_of],
                                arrs["env_mass"][w_of])
            with spans.span("oneshot.wait"):
                keep = (lb <= eps).nonzero().squeeze(1)
            lb_rows = n_need
            lb_pruned = n_need - int(keep.numel())
            rows = ring_filter.Rows(*(t[keep] for t in rows))
        n_evals = int(rows.q_of.numel())
        n_pruned = 0
        if n_evals:
            # and evaluate — fused ε: the kernel returns the hit mask, set
            # in by one scatter of True (a miss writes the spare byte).
            # Nothing waits for the card here: ε is filled on the card, as
            # a copy of a host scalar would wait for the stream
            out = spec.device_call(
                rows.xs, rows.ys, lx=rows.q_len,
                eps=torch.full((n_evals,), eps, device=dev))
            cells.index_fill_(0, torch.where(
                out.hit, rows.q_of * N + rows.w_of, Q * N), True)
            n_pruned = out.pruned.sum()
    return hits, n_need, n_evals, n_pruned, lb_rows, lb_pruned


def _envelope_rows(dist_name: str, xq, q_lens, env_lo, env_hi, env_mass):
    """One-direction envelope bound of query rows ``xq`` against the
    candidates' precomputed boxes (``(C, d)``) and gap masses (``(C,)``):
    ``bounds.lb_envelope_rows`` bit for bit (numpy's sum orders and
    root)."""
    if xq.ndim == 2:
        xq = xq[..., None]
    xq = xq.to(torch.float32)
    Lq = xq.shape[1]
    mx = torch.arange(Lq, device=xq.device)[None, :] < q_lens[:, None]
    lo_r = env_lo[:, None, :]                               # (C, 1, d)
    hi_r = env_hi[:, None, :]
    gap = torch.clamp_min(lo_r - xq, 0.0) + torch.clamp_min(xq - hi_r, 0.0)
    bd = sqrt_rn(torch.clamp_min(sum_last(gap * gap), 0.0))  # (C, L)
    if dist_name == "frechet":
        return torch.where(mx, bd, 0.0).amax(dim=1)
    if dist_name == "dtw":
        return sum_last(bd * mx)
    # erp: element consumption + global gap-mass bound
    gx = torch.where(mx, sqrt_rn(
        torch.clamp_min(sum_last(xq * xq), 0.0)), 0.0)
    cons = sum_last(torch.minimum(gx, bd) * mx)
    gm = (sum_last(gx) - env_mass).abs()
    return torch.maximum(cons, gm)


def host_reference_hits(flat: FlatNet, qs: np.ndarray, eps: float
                        ) -> np.ndarray:
    """Oracle: exact (Q, N) hit mask by brute force (numpy backend)."""
    batch = np_backend.batch_for(flat.dist_name)
    Q, N = qs.shape[0], len(flat.data)
    # ONE stacked oracle call over the full (Q, N) cross product
    ds = np.asarray(batch(
        np.repeat(qs, N, axis=0),
        np.tile(flat.data, (Q,) + (1,) * (flat.data.ndim - 1))))
    return ds.reshape(Q, N) <= eps


# -- fleet (multi-shard) version ---------------------------------------------

def merge_flats(flats: Sequence[FlatNet]) -> Tuple[FlatNet, List[int]]:
    """Stack per-shard FlatNets into ONE flat net over the union.

    Shards partition the windows, so concatenating pivot rows and pairs
    (each shard's pair pivots offset by the pivot rows before it, its
    member ids by the windows before it) yields a FlatNet whose single
    device query equals the union of the per-shard queries.  Pivot
    identities survive the merge — ``pivot_ids`` concatenate with the same
    per-shard offsets, so post-merge :meth:`FlatNet.append` refreshes keep
    working — when every input carries them (otherwise the merged net's
    are None).  Returns the merged net plus each shard's column offset into
    the merged hit mask.  The merged net is a new object, so it uploads its
    own device arrays on first use.
    """
    assert flats, "nothing to merge"
    assert len({f.dist_name for f in flats}) == 1, "mixed distances"
    offsets: List[int] = []
    mem_pivot, mem_id, off, row = [], [], 0, 0
    for f in flats:
        offsets.append(off)
        mem_pivot.append(f.mem_pivot + row)
        mem_id.append(f.mem_id + off)
        off += len(f.data)
        row += len(f.pivots)
    pivot_ids = None
    if all(f.pivot_ids is not None for f in flats):
        pivot_ids = np.concatenate(
            [np.asarray(f.pivot_ids, np.int64) + o
             for f, o in zip(flats, offsets)])
    envs = None
    if all(f.envelopes is not None for f in flats):
        e0 = flats[0].envelopes
        envs = bounds.EnvelopeSet(e0.lo.copy(), e0.hi.copy(),
                                  e0.mass.copy(), e0.cum.copy(),
                                  e0.lens.copy())
        for f in flats[1:]:
            envs.extend(f.envelopes)
    return FlatNet(
        pivots=np.concatenate([f.pivots for f in flats]),
        pivot_radius=np.concatenate([f.pivot_radius for f in flats]),
        mem_pivot=np.concatenate(mem_pivot),
        mem_id=np.concatenate(mem_id),
        mem_dist=np.concatenate([f.mem_dist for f in flats]),
        data=np.concatenate([f.data for f in flats]),
        n_pivots=sum(f.n_pivots for f in flats),
        dist_name=flats[0].dist_name, pivot_ids=pivot_ids,
        envelopes=envs), offsets


def fleet_range_query(flats: List[FlatNet], qs: np.ndarray, eps: float,
                      *, dead: Tuple[int, ...] = (), stacked: bool = True,
                      merged: Optional[Tuple[FlatNet, List[int]]] = None,
                      **kw):
    """Union of per-shard device queries (shards partition the windows).

    This is the fleet's *one-shot* serving primitive — the elastic layer's
    fallback mode (``mode="oneshot"``); default serving goes round-based
    through ``FleetBatchEngine`` instead, which prunes with the full
    reference-net frontier (see ``launch/elastic.py``).

    ``dead`` shards are skipped (the elastic layer rebuilds them); the
    returned mask is per-shard so the caller can re-issue stolen work.

    ``stacked`` (default) merges the alive shards' FlatNet arrays with
    :func:`merge_flats` and runs ONE device query over the stack — one
    pivot-kernel call and one survivor compaction for the whole fleet
    instead of a sequential host-Python loop over shards.  Results are
    identical; per-shard masks are column slices of the merged mask.  A
    merged run cannot attribute evaluations to individual shards, so each
    alive shard's stats entry is an independent dict tagged
    ``merged=True`` whose counters use ``fleet_*`` keys (summing them
    across shards would double-count — old per-shard keys are absent on
    purpose).  ``stacked=False`` keeps the per-shard loop with the
    classic per-shard stats.

    ``merged`` lets a serving layer pass a precomputed
    ``merge_flats``-of-the-alive-shards result (net, offsets) so repeated
    queries against an unchanged fleet skip the per-call merge (and keep
    its device arrays); it MUST correspond to the current alive list or the
    column slicing is wrong.  Other keywords go to
    :func:`device_range_query`.
    """
    alive = [(i, f) for i, f in enumerate(flats) if i not in dead]
    results: List[Optional[np.ndarray]] = [None] * len(flats)
    stats: List[Optional[dict]] = [None] * len(flats)
    if stacked and len(alive) > 1:
        if merged is not None:
            mnet, offsets = merged
        else:
            mnet, offsets = merge_flats([f for _, f in alive])
        hits, s = device_range_query(mnet, qs, eps, **kw)
        fleet = {"merged": True, "n_shards": len(alive),
                 "capacity": s["capacity"],
                 "fleet_pivot_evals": s["pivot_evals"],
                 "fleet_member_evals": s["member_evals"],
                 "fleet_fused_pruned": s.get("fused_pruned", 0),
                 "fleet_lb_rows": s.get("lb_rows", 0),
                 "fleet_lb_pruned": s.get("lb_pruned", 0),
                 "fleet_total_evals": s["total_evals"],
                 "fleet_filter_slots": s["filter_slots"]}
        for (i, f), off in zip(alive, offsets):
            results[i] = hits[:, off:off + len(f.data)]
            stats[i] = dict(fleet)
        return results, stats
    for i, f in alive:
        h, st = device_range_query(f, qs, eps, **kw)
        results[i] = h
        stats[i] = st
    return results, stats
