"""Zero-downtime fleet snapshot/restore for the serve layer.

A live :class:`~repro_torch.launch.elastic.ElasticIndex` is, per shard,
three structures the reference net's O(n) layout keeps cheap to dump: the
host node graph (``ReferenceNet.nodes`` — id/level/radius scalars plus
ragged child/parent adjacency), the device
:class:`~repro_torch.core.distributed.FlatNet` (dense pivot/member arrays
+ precomputed envelopes), and the ``gids`` map from local rows to global
window ids.  This module serializes all of it to ONE ``.npz`` +
``meta.json`` per snapshot through the training stack's
:class:`~repro_torch.train.checkpoint.CheckpointManager` — inheriting its
atomic tmp-dir + fsync + rename write, ``latest`` pointer,
background-thread async save, and retention — and restores a
fully-serving clone **without spending a single distance evaluation**:
nodes, flats, and envelopes are rebuilt from arrays, never recomputed, and
the per-shard counter buckets are restored verbatim so ``eval_count()``
parity holds across a round-trip.

The serve engine's zero-downtime ``resize()`` is built on this: snapshot
the live fleet (blocking — the arrays are copied out under the caller's
control), restore a clone, reshard the *clone* while the original keeps
serving in-flight traffic, then swap atomically at a round boundary.

The on-disk format is the reference's (``src/repro/serve/snapshot.py``),
so either package restores the other's snapshots: backends are written
under the reference's names (``kernel`` as ``pallas``, ``torch`` as
``jax``) and read back under the port's, the reference's TPU knobs are
written at its defaults and ignored on restore, and the fleet's device is
an extra key the reference ignores.  A restore puts every shard's counter
(and so its window table) on the device it is given — by default the one
recorded in the snapshot, else the card.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager

#: port backend name -> the reference's, as written to disk
_REF_BACKEND = {"kernel": "pallas", "torch": "jax", "numpy": "numpy"}
_PORT_BACKEND = {v: k for k, v in _REF_BACKEND.items()}


def _shard_arrays(wi: int, shard) -> Dict[str, np.ndarray]:
    """Dump one shard's net + flat + gids as flat npz-ready arrays."""
    net, flat = shard.net, shard.flat
    node_ids = sorted(net.nodes)
    child_cnt, parent_cnt = [], []
    child_ids, child_dist, child_level, parent_ids = [], [], [], []
    for x in node_ids:
        n = net.nodes[x]
        child_cnt.append(len(n.children))
        parent_cnt.append(len(n.parents))
        child_ids.extend(n.children)
        child_dist.extend(n.child_dist)
        child_level.extend(n.child_level)
        parent_ids.extend(n.parents)
    p = f"s{wi}/"
    out = {
        p + "gids": np.array(shard.gids, np.int64),
        p + "sdata": np.array(net.counter.data),
        p + "node_ids": np.array(node_ids, np.int64),
        p + "node_level": np.array([net.nodes[x].level for x in node_ids],
                                   np.int64),
        p + "node_subr": np.array([net.nodes[x].sub_radius
                                   for x in node_ids], np.float64),
        p + "child_cnt": np.array(child_cnt, np.int64),
        p + "child_ids": np.array(child_ids, np.int64),
        p + "child_dist": np.array(child_dist, np.float64),
        p + "child_level": np.array(child_level, np.int64),
        p + "parent_cnt": np.array(parent_cnt, np.int64),
        p + "parent_ids": np.array(parent_ids, np.int64),
        p + "pivots": np.array(flat.pivots),
        p + "pivot_radius": np.array(flat.pivot_radius),
        p + "members": np.array(flat.members),
        p + "member_dist": np.array(flat.member_dist),
        p + "pivot_ids": np.array(flat.pivot_ids, np.int64),
    }
    if flat.envelopes is not None:
        e = flat.envelopes
        out.update({p + "env_lo": np.array(e.lo), p + "env_hi": np.array(e.hi),
                    p + "env_mass": np.array(e.mass),
                    p + "env_cum": np.array(e.cum),
                    p + "env_lens": np.array(e.lens)})
    return out


def _shard_meta(shard) -> dict:
    net = shard.net
    c = net.counter
    return {"root": int(net.root), "top_level": int(net.top_level),
            "n_pivots": int(shard.flat.n_pivots),
            "has_env": shard.flat.envelopes is not None,
            "count": c.count, "dispatches": c.dispatches,
            "lb_count": c.lb_count, "build_count": c.build_count,
            "build_dispatches": c.build_dispatches,
            "lb_tier_rows": c.lb_tier_rows,
            "lb_tier_pruned": c.lb_tier_pruned}


class FleetSnapshotManager:
    """Snapshot/restore a live fleet; atomic writes via CheckpointManager."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self._ckpt = CheckpointManager(directory, keep=keep,
                                       async_save=async_save)

    # -- save ---------------------------------------------------------------

    def save(self, fleet, step: Optional[int] = None,
             block: bool = False) -> int:
        """Snapshot ``fleet`` (an ElasticIndex).  Arrays are copied out
        synchronously — the fleet may keep mutating (resize, append) the
        moment this returns — and the disk write runs on the checkpoint
        manager's background thread unless ``block``."""
        if step is None:
            last = self._ckpt.latest_step()
            step = 0 if last is None else last + 1
        arrays: Dict[str, np.ndarray] = {"fleet/data": np.array(fleet.data)}
        shard_meta: Dict[str, dict] = {}
        for wi, w in enumerate(fleet.workers):
            s = fleet.shards.get(w)
            if s is None:
                continue
            arrays.update(_shard_arrays(wi, s))
            shard_meta[str(wi)] = _shard_meta(s)
        meta = {"kind": "fleet_snapshot",
                "dist": fleet.dist.name,
                "workers": list(fleet.workers),
                "eps_prime": fleet.eps_prime, "tight": fleet.tight,
                "backend": _REF_BACKEND[fleet.backend],
                "max_cohort": fleet.max_cohort,
                "interpret": True, "fleet_mode": fleet.fleet_mode,
                "lb_cascade": fleet.lb_cascade,
                "kernel_exec": None, "kernel_tile": None,
                "device": str(fleet.device),
                "retired": dict(fleet._retired),
                "device_stats": dict(fleet.device_stats),
                "shards": shard_meta}
        self._ckpt.save(step, arrays, extra=meta, block=block)
        return step

    def wait(self) -> None:
        self._ckpt.wait()

    def latest_step(self) -> Optional[int]:
        return self._ckpt.latest_step()

    # -- restore ------------------------------------------------------------

    def restore(self, step: Optional[int] = None, *, device=None):
        """Rebuild a fully-serving ElasticIndex clone from a snapshot, with
        its counters on ``device`` (default: the snapshot's device, else
        the card).

        Zero distance evaluations: the node graph, flat arrays, envelopes,
        and counter buckets are restored verbatim, so hit sets AND
        ``{query, build}`` counts match the never-snapshotted fleet."""
        from repro_torch import device as device_mod
        from repro_torch.core.counter import CountedDistance
        from repro_torch.core.distributed import FlatNet
        from repro_torch.core.refnet import Node, ReferenceNet
        from repro_torch.distances import base as dist_base
        from repro_torch.distances.bounds import EnvelopeSet
        from repro_torch.launch import elastic

        if step is None:
            step = self._ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no fleet snapshot in {self.dir}")
        path = self.dir / f"step_{step:010d}"
        with np.load(path / "state.npz") as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads((path / "meta.json").read_text())
        if meta.get("kind") != "fleet_snapshot":
            raise ValueError(f"{path} is not a fleet snapshot")

        dist = dist_base.require_metric(meta["dist"])
        fleet = elastic.ElasticIndex.__new__(elastic.ElasticIndex)
        fleet.dist = dist
        fleet.data = arrays["fleet/data"]
        fleet.eps_prime = meta["eps_prime"]
        fleet.tight = meta["tight"]
        fleet.backend = _PORT_BACKEND[meta["backend"]]
        fleet.device = device_mod.resolve(
            meta.get("device") if device is None else device)
        fleet.max_cohort = meta["max_cohort"]
        fleet.fleet_mode = meta["fleet_mode"]
        fleet.lb_cascade = meta["lb_cascade"]
        fleet.workers = list(meta["workers"])
        # rendezvous assignment is a pure function of (n windows, workers)
        fleet.assignment = elastic.assign(range(len(fleet.data)),
                                          fleet.workers)
        fleet._retired = {k: int(v) for k, v in meta["retired"].items()}
        fleet._merged = None
        fleet._round_eval = None
        fleet.device_stats = {k: int(v)
                              for k, v in meta["device_stats"].items()}
        fleet.shards = {}
        for wi, w in enumerate(fleet.workers):
            sm = meta["shards"].get(str(wi))
            if sm is None:
                fleet.shards[w] = None
                continue
            p = f"s{wi}/"
            sdata = arrays[p + "sdata"]
            counter = CountedDistance(dist, sdata, backend=fleet.backend,
                                      device=fleet.device)
            counter.count = int(sm["count"])
            counter.dispatches = int(sm["dispatches"])
            counter.lb_count = int(sm["lb_count"])
            counter.build_count = int(sm["build_count"])
            counter.build_dispatches = int(sm["build_dispatches"])
            counter.lb_tier_rows = dict(sm["lb_tier_rows"])
            counter.lb_tier_pruned = dict(sm["lb_tier_pruned"])
            net = ReferenceNet(dist, counter.data,
                               eps_prime=fleet.eps_prime,
                               tight_bounds=fleet.tight, counter=counter)
            net.root = sm["root"]
            net.top_level = sm["top_level"]
            node_ids = arrays[p + "node_ids"]
            levels = arrays[p + "node_level"]
            subrs = arrays[p + "node_subr"]
            ccnt, pcnt = arrays[p + "child_cnt"], arrays[p + "parent_cnt"]
            coff = np.concatenate([[0], np.cumsum(ccnt)])
            poff = np.concatenate([[0], np.cumsum(pcnt)])
            cids = arrays[p + "child_ids"]
            cdist = arrays[p + "child_dist"]
            clevel = arrays[p + "child_level"]
            pids = arrays[p + "parent_ids"]
            for k, x in enumerate(node_ids):
                a, b = int(coff[k]), int(coff[k + 1])
                pa, pb = int(poff[k]), int(poff[k + 1])
                net.nodes[int(x)] = Node(
                    idx=int(x), level=int(levels[k]),
                    children=[int(c) for c in cids[a:b]],
                    child_dist=[float(d) for d in cdist[a:b]],
                    child_level=[int(c) for c in clevel[a:b]],
                    parents=[int(c) for c in pids[pa:pb]],
                    sub_radius=float(subrs[k]))
            envs = None
            if sm["has_env"]:
                envs = EnvelopeSet(arrays[p + "env_lo"],
                                   arrays[p + "env_hi"],
                                   arrays[p + "env_mass"],
                                   arrays[p + "env_cum"],
                                   arrays[p + "env_lens"])
            flat = FlatNet(pivots=arrays[p + "pivots"],
                           pivot_radius=arrays[p + "pivot_radius"],
                           members=arrays[p + "members"],
                           member_dist=arrays[p + "member_dist"],
                           data=counter.data,
                           n_pivots=int(sm["n_pivots"]),
                           dist_name=dist.name,
                           pivot_ids=arrays[p + "pivot_ids"],
                           envelopes=envs)
            fleet.shards[w] = elastic._Shard(net=net, flat=flat,
                                             gids=arrays[p + "gids"])
        return fleet
