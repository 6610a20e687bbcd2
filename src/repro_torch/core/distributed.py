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

The reference compacts with a static capacity (``jnp.nonzero(size=)``)
and retries at twice the capacity on overflow.  PyTorch compacts to the
exact survivor count (``torch.nonzero``: one host synchronisation each),
so nothing is retried; ``stats["capacity"]`` still reports the capacity
the reference's doubling rule ends at, computed from the survivor count.

The FlatNet's arrays (and envelopes) are uploaded to a device once per
FlatNet version and kept there (:meth:`FlatNet.device_arrays`); ``append``
and ``remove`` drop the copy.  The fleet version merges the alive shards'
FlatNets (:func:`merge_flats`) into ONE device query; results are exact
unions, since shards partition the windows.

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
from repro_torch.kernels.wavefront import lev_operand


@dataclasses.dataclass
class FlatNet:
    """Flattened (pivot -> members) arrays; member lists padded to one
    width."""
    pivots: np.ndarray          # (P, l[, d]) pivot windows
    pivot_radius: np.ndarray    # (P,) exact derived-subtree radius
    members: np.ndarray         # (P, M) window ids, -1 padding
    member_dist: np.ndarray     # (P, M) exact delta(pivot, member)
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

    @property
    def eval_width(self) -> int:
        return self.members.shape[1]

    def device_arrays(self, dev: torch.device) -> Dict[str, torch.Tensor]:
        """The query operands on ``dev``, uploaded once per FlatNet version
        (``append``/``remove`` drop the copy): pivots, radii, member ids
        (padding clamped to 0) with their validity mask and distances, the
        window database and, when present, the envelopes.  Token ids go up
        as the kernel takes them (int32, range-checked here), so no query
        converts or checks them again."""
        if self._on_device is not None and self._on_device[0] == dev:
            return self._on_device[1]
        rows = _operand_of(self.dist_name)
        arrs = {"pivots": rows(self.pivots),
                "pradius": torch.as_tensor(self.pivot_radius),
                "members": torch.as_tensor(np.maximum(self.members, 0)),
                "mem_valid": torch.as_tensor(self.members >= 0),
                "mem_dist": torch.as_tensor(self.member_dist),
                "data": rows(self.data)}
        if self.envelopes is not None:
            arrs["env_lo"] = torch.as_tensor(self.envelopes.lo)
            arrs["env_hi"] = torch.as_tensor(self.envelopes.hi)
            arrs["env_mass"] = torch.as_tensor(self.envelopes.mass)
        arrs = {k: v.to(dev) for k, v in arrs.items()}
        self._on_device = (dev, arrs)
        return arrs

    def append(self, pivot_rows: Sequence[int], member_ids: Sequence[int],
               member_dists: Sequence[float], new_data: Optional[np.ndarray]
               = None) -> "FlatNet":
        """Incrementally attach members (``member_ids[k]`` under pivot row
        ``pivot_rows[k]`` at distance ``member_dists[k]``) in place.

        ``new_data`` extends the window database when the ids are fresh
        (online inserts after flattening); member lists re-pad to the new
        width and pivot radii grow monotonically, so a refreshed net never
        needs a full re-flatten to stay queryable on device.
        """
        self._on_device = None
        if new_data is not None and len(new_data):
            new_data = np.asarray(new_data)
            self.data = np.concatenate([self.data, new_data])
            if self.envelopes is not None:  # incremental envelope refresh
                self.envelopes.extend(bounds.build_envelopes(new_data))
        pivot_rows = np.asarray(pivot_rows, np.int64)
        member_ids = np.asarray(member_ids, np.int64)
        member_dists = np.asarray(member_dists, np.float32)
        counts = (self.members >= 0).sum(axis=1)
        need = counts.copy()
        for p in pivot_rows:
            need[p] += 1
        grow = int(need.max() - self.members.shape[1])
        if grow > 0:
            P = self.members.shape[0]
            self.members = np.concatenate(
                [self.members, np.full((P, grow), -1, np.int64)], axis=1)
            self.member_dist = np.concatenate(
                [self.member_dist, np.zeros((P, grow), np.float32)], axis=1)
        for p, w, d in zip(pivot_rows, member_ids, member_dists):
            k = int(counts[p])
            self.members[p, k] = w
            self.member_dist[p, k] = d
            counts[p] += 1
            if d > self.pivot_radius[p]:
                self.pivot_radius[p] = d
        return self

    def remove(self, member_ids: Sequence[int]) -> "FlatNet":
        """Mask windows out of every member list in place — zero distance
        evaluations.

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
        drop = np.isin(self.members, ids) & (self.members >= 0)
        masked = np.where(drop, -1, self.members)
        # re-compact each row (live entries left, padding right): `append`
        # writes at the first slot past the live count, so holes must not
        # hide live members behind them
        order = np.argsort(masked < 0, axis=1, kind="stable")
        self.members = np.take_along_axis(masked, order, axis=1)
        self.member_dist = np.take_along_axis(self.member_dist, order, axis=1)
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
    M = max(len(m) for m in members)
    P = len(pivot_ids)
    mem = np.full((P, M), -1, np.int64)
    mdist = np.zeros((P, M), np.float32)
    # reuse stored link distances for direct children; stack the rest into
    # one batched dispatch (no per-pivot host loop)
    eval_l: List[int] = []
    eval_r: List[int] = []
    eval_at: List[Tuple[int, int]] = []
    for i, (pid, ms) in enumerate(zip(pivot_ids, members)):
        mem[i, :len(ms)] = ms
        pn = net.nodes[pid]
        link = {c: pn.child_dist[k] for k, c in enumerate(pn.children)}
        for j, x in enumerate(ms):
            if x == pid:
                mdist[i, j] = 0.0
            elif x in link:
                mdist[i, j] = link[x]
            else:
                eval_l.append(pid)
                eval_r.append(x)
                eval_at.append((i, j))
    if eval_l:
        ds = net.counter.eval_pairs(eval_l, eval_r)
        for (i, j), d in zip(eval_at, ds):
            mdist[i, j] = float(d)
    valid = mem >= 0
    radius = np.where(valid.any(axis=1),
                      np.where(valid, mdist, 0.0).max(axis=1),
                      0.0).astype(np.float32)
    # one stacked envelope pass over the whole window database (reused by
    # fleet rounds and the device query path instead of per-query rebuilds)
    envs = bounds.build_envelopes(net.data) \
        if net.dist.envelope_bound is not None else None
    return FlatNet(
        pivots=np.asarray(net.data[pivot_ids]),
        pivot_radius=radius,
        members=mem, member_dist=mdist,
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
        q_lens_t = device_mod.as_tensor(np.asarray(q_lens), dev, torch.int64)
    hits, n_need, n_evals, n_pruned, lb_rows, lb_pruned = _device_query(
        qs_t, q_lens_t, arrs, float(eps), flat.dist_name, use_env)
    stats = {"pivot_evals": Q * flat.n_pivots,
             "member_evals": n_evals,
             "fused_pruned": n_pruned,
             "lb_rows": lb_rows,
             "lb_pruned": lb_pruned,
             "capacity": final_capacity(capacity, n_need),
             "total_evals": Q * flat.n_pivots + n_evals}
    with spans.span("oneshot.fetch"):
        with spans.span("oneshot.wait"):
            hits = hits.cpu()
        return hits.numpy(), stats


def _device_query(qs, q_lens, arrs, eps: float, dist_name: str,
                  use_env: bool):
    """The one-shot query on the operands' device: ``(hits (Q, N) bool
    tensor, n_need, member_evals, fused_pruned, lb_rows, lb_pruned)``.

    One wavefront launch for the ``Q * P`` query-pivot rows (eps = +inf:
    the values feed the ring bounds) and one for the survivors when there
    are any; each compaction is one ``torch.nonzero``."""
    pivots, pradius = arrs["pivots"], arrs["pradius"]
    members, mem_valid = arrs["members"], arrs["mem_valid"]
    mem_dist, data = arrs["mem_dist"], arrs["data"]
    dev = qs.device
    Q = qs.shape[0]
    P, M = members.shape
    N = data.shape[0]
    spec = kernel_registry.get(dist_name)
    # each read that blocks on the card (a nonzero, a boolean index, a sum
    # read back) is an ``oneshot.wait`` span inside its phase
    with spans.span("oneshot.pivots"):
        # 1. queries x pivots — value-consuming (feeds the ring bounds)
        qs_rep = qs.repeat_interleave(P, dim=0)
        pv_rep = pivots.repeat((Q,) + (1,) * (pivots.ndim - 1))
        dp = spec.device_call(qs_rep, pv_rep, lx=q_lens.repeat_interleave(P)
                              ).dist.reshape(Q, P)
    with spans.span("oneshot.bounds"):
        # 2. pivot verdicts
        acc_all = dp + pradius[None, :] <= eps            # accept whole list
        prune_all = dp - pradius[None, :] > eps
        undecided = ~(acc_all | prune_all)
        # 3. member ring bounds for undecided pivots
        lo = (dp[:, :, None] - mem_dist[None, :, :]).abs()   # (Q, P, M)
        hi = dp[:, :, None] + mem_dist[None, :, :]
        member_live = mem_valid[None, :, :] & undecided[:, :, None]
        accept_m = member_live & (hi <= eps)
        need_eval = member_live & (lo <= eps) & (hi > eps)
        del lo, hi, member_live
        # free verdicts into the (Q, N) hit mask: an index-put of True at
        # the accepted (q, w) pairs (duplicates are harmless)
        hits = torch.zeros((Q, N), dtype=torch.bool, device=dev)
        free_in = (acc_all[:, :, None] & mem_valid[None]) | accept_m
        with spans.span("oneshot.wait"):
            qq, pp, mm = free_in.nonzero(as_tuple=True)
        hits[qq, members[pp, mm]] = True
        del free_in, accept_m
    with spans.span("oneshot.compact"):
        # 4. compact survivors (exact size: every selected row is real)
        with spans.span("oneshot.wait"):
            sel = need_eval.reshape(-1).nonzero().squeeze(1)
        del need_eval
        n_need = int(sel.numel())
        q_of = sel // (P * M)
        w_of = members.reshape(-1)[sel % (P * M)]
    with spans.span("oneshot.survivors"):
        lb_rows = lb_pruned = 0
        if use_env:
            # 4b. envelope stage on the compacted survivors: gather the
            # PRECOMPUTED per-window boxes/masses (built once at flatten
            # time) and compact a second time, so only rows the envelope
            # bound cannot certify as > eps reach the exact wavefront.
            # One-direction form of the sound bounds in
            # ``distances/bounds.py::lb_envelope_rows``.
            lb = _envelope_rows(dist_name, qs[q_of], q_lens[q_of],
                                arrs["env_lo"][w_of], arrs["env_hi"][w_of],
                                arrs["env_mass"][w_of])
            with spans.span("oneshot.wait"):
                keep = (lb <= eps).nonzero().squeeze(1)
            lb_rows = n_need
            lb_pruned = n_need - int(keep.numel())
            q_of, w_of = q_of[keep], w_of[keep]
        n_evals = int(q_of.numel())
        n_pruned = 0
        if n_evals:
            # and evaluate — fused ε: the kernel returns the hit mask
            out = spec.device_call(qs[q_of], data[w_of], lx=q_lens[q_of],
                                   eps=eps)
            with spans.span("oneshot.wait"):
                hits[q_of[out.hit], w_of[out.hit]] = True
            with spans.span("oneshot.wait"):
                n_pruned = int(out.pruned.sum())
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

    Shards partition the windows, so concatenating pivot rows (member ids
    offset into the concatenated data array, member widths padded to the
    fleet maximum) yields a FlatNet whose single device query equals the
    union of the per-shard queries.  Pivot identities survive the merge —
    ``pivot_ids`` concatenate with the same per-shard offsets, so post-merge
    :meth:`FlatNet.append` refreshes keep working — when every input carries
    them (otherwise the merged net's are None).  Returns the merged net plus
    each shard's column offset into the merged hit mask.  The merged net is
    a new object, so it uploads its own device arrays on first use.
    """
    assert flats, "nothing to merge"
    assert len({f.dist_name for f in flats}) == 1, "mixed distances"
    M = max(f.members.shape[1] for f in flats)
    offsets: List[int] = []
    mems, mdists, off = [], [], 0
    for f in flats:
        offsets.append(off)
        pad = M - f.members.shape[1]
        mem = np.pad(f.members, ((0, 0), (0, pad)), constant_values=-1)
        mems.append(np.where(mem >= 0, mem + off, -1))
        mdists.append(np.pad(f.member_dist, ((0, 0), (0, pad))))
        off += len(f.data)
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
        members=np.concatenate(mems),
        member_dist=np.concatenate(mdists),
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
                 "fleet_total_evals": s["total_evals"]}
        for (i, f), off in zip(alive, offsets):
            results[i] = hits[:, off:off + len(f.data)]
            stats[i] = dict(fleet)
        return results, stats
    for i, f in alive:
        h, st = device_range_query(f, qs, eps, **kw)
        results[i] = h
        stats[i] = st
    return results, stats
