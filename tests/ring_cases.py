"""Operands of the one-shot query's ring filter for its tests, on the CPU and
on the card, and the padded ``(Q, P, M)`` broadcast it replaced, as the
oracle of its verdicts and of their order.  Imports only torch and numpy.

A case is ``(dp, pradius, members, member_dist, eps)``: ``members`` ``(P,
M)`` window ids padded with -1 (live entries left, as the reference's
FlatNet and the snapshot file keep them), one list far wider than the
rest, as the flattened fleets of the benchmark hold one huge pivot per
shard.
"""

import numpy as np
import torch

#: the cases :func:`case` builds
CASES = ("random", "ties", "none", "all")


def csr(members, member_dist):
    """The valid pairs as ``FlatNet.device_arrays`` uploads them, read off
    the padded lists by a loop: ``(pivot int32, id int32, dist f32)``."""
    pv, ids, ds = [], [], []
    for p in range(members.shape[0]):
        for m in range(members.shape[1]):
            if members[p, m] >= 0:
                pv.append(p)
                ids.append(members[p, m])
                ds.append(member_dist[p, m])
    return (np.asarray(pv, np.int32), np.asarray(ids, np.int32),
            np.asarray(ds, np.float32))


def case(name, Q=7, P=9, N=300, seed=0):
    """Ring operands for case ``name`` (:data:`CASES`):

    * ``random``: distances anywhere, some lists accepted or pruned whole;
    * ``ties``: every value a multiple of 1/4, so ``eps`` falls exactly on
      ``dp +- mdist`` and ``dp +- pradius`` in many slots;
    * ``none``: ``eps`` below every bound: no hit and no survivor;
    * ``all``: every pair a survivor (radii too wide for a whole-list
      verdict, ``|dp - mdist| <= eps < dp + mdist`` everywhere).
    """
    rng = np.random.default_rng(seed)
    # one giant list, the rest short and ragged (some empty)
    sizes = rng.integers(0, 6, P)
    sizes[P // 2] = N - sizes.sum() + sizes[P // 2]
    assert sizes[P // 2] > N // 2
    M = int(sizes.max())
    ids = rng.permutation(N)
    members = np.full((P, M), -1, np.int64)
    at = 0
    for p, k in enumerate(sizes):
        members[p, :k] = ids[at:at + k]
        at += k
    if name == "ties":
        md = rng.integers(0, 24, (P, M)) / 4
        pradius = rng.integers(0, 24, P) / 4
        dp = rng.integers(0, 40, (Q, P)) / 4
        eps = 3.0
        g = P // 2                          # whole lists at both bounds
        pradius[g] = 1.0
        dp[1, g], dp[2, g] = eps - 1.0, eps + 1.0
    elif name == "all":
        md = rng.uniform(0.5, 1.0, (P, M))
        pradius = np.full(P, 100.0)
        dp = rng.uniform(5.0, 5.2, (Q, P))
        eps = 5.4
    else:
        md = rng.uniform(0.0, 6.0, (P, M))
        pradius = md.max(axis=1)
        dp = rng.uniform(0.0, 12.0, (Q, P))
        dp[0, 0] = 0.0                      # a list accepted whole
        eps = -1.0 if name == "none" else 2.5
    member_dist = np.where(members >= 0, md, 0.0).astype(np.float32)
    return (dp.astype(np.float32), pradius.astype(np.float32), members,
            member_dist, eps)


def padded(dp, pradius, members, member_dist, eps, N):
    """The padded broadcast: ``(hits (Q, N) bool, q_of, w_of)``, survivors
    in ``nonzero``'s ``(q, p, m)`` order.  Torch tensors in, on any
    device."""
    Q, (P, M) = dp.shape[0], members.shape
    valid = members >= 0
    mem = members.clamp_min(0)
    acc_all = dp + pradius[None, :] <= eps
    prune_all = dp - pradius[None, :] > eps
    undecided = ~(acc_all | prune_all)
    lo = (dp[:, :, None] - member_dist[None, :, :]).abs()
    hi = dp[:, :, None] + member_dist[None, :, :]
    live = valid[None] & undecided[:, :, None]
    accept = live & (hi <= eps)
    need = live & (lo <= eps) & (hi > eps)
    hits = torch.zeros((Q, N), dtype=torch.bool, device=dp.device)
    qq, pp, mm = ((acc_all[:, :, None] & valid[None]) | accept).nonzero(
        as_tuple=True)
    hits[qq, mem[pp, mm]] = True
    sel = need.reshape(-1).nonzero().squeeze(1)
    return hits, sel // (P * M), mem.reshape(-1)[sel % (P * M)]


def boundary_slots(dp, pradius, members, member_dist, eps):
    """How many valid slots sit exactly at each boundary (f32 sums):
    ``{"dp+md", "|dp-md|", "dp+pr", "dp-pr"}``."""
    dp = dp.astype(np.float32)
    valid = (members >= 0)[None]
    e = np.float32(eps)
    hi = dp[:, :, None] + member_dist[None]
    lo = np.abs(dp[:, :, None] - member_dist[None])
    whole = np.broadcast_to(valid, hi.shape)
    return {"dp+md": int(((hi == e) & valid).sum()),
            "|dp-md|": int(((lo == e) & valid).sum()),
            "dp+pr": int(((dp + pradius[None] == e)[:, :, None]
                          & whole).sum()),
            "dp-pr": int(((dp - pradius[None] == e)[:, :, None]
                          & whole).sum())}


#: fractions of an f32 spacing :func:`between` steps off an f32 value: a
#: quarter rounds back to it, a half is a tie that rounds to the even one
FRACTIONS = (-0.5, -0.25, 0.25, 0.5)


def between(x, frac):
    """The f64 ``frac`` of the way from the f32 value ``x`` to its f32
    neighbour (above it for ``frac > 0``, below otherwise): an ``eps`` that
    no f32 holds, so a filter that compared in f64, or rounded ``eps``
    another way than to the nearest f32 (ties to even), gives other
    verdicts there."""
    x = np.float32(x)
    nb = np.nextafter(x, np.float32(np.inf if frac > 0 else -np.inf))
    e = float(x) + abs(frac) * (float(nb) - float(x))
    assert float(np.float32(e)) != e
    return e


def undecided_pair(dp, pradius, pivot, mdist, rng):
    """A real (query, pair) slot whose pivot gives no whole-list verdict
    near its member's bounds (``0 < mdist < pradius``, ``dp != mdist``):
    ``(q, j, dp + mdist, |dp - mdist|)`` in f32."""
    Q = dp.shape[0]
    for j in rng.permutation(len(pivot)):
        p = pivot[j]
        if not 0 < mdist[j] < pradius[p]:
            continue
        for q in rng.permutation(Q):
            if dp[q, p] != mdist[j]:
                d, m = np.float32(dp[q, p]), np.float32(mdist[j])
                return int(q), int(j), d + m, np.abs(d - m)
    raise AssertionError("no undecided pair")
