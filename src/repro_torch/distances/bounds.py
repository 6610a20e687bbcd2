"""Cheap, provable lower bounds for the batch engine's LB cascade.

Each function is vectorized numpy over row-paired batches and satisfies
``lb(x, y) <= delta(x, y)`` row-wise, so pruning a candidate whose bound
already exceeds eps can never change a range-query verdict — only skip its
exact O(l^2) DP.

The cascade has two tiers (``LB_TIERS``; :func:`normalize_tier` maps the
legacy booleans onto them):

* **tier 0 — endpoint** (O(B) per batch): the historic LB_Kim-style
  endpoint / global-gap-mass bounds below.

  - DTW — every warping path aligns (1,1) and (lx,ly); both cells carry
    nonnegative cost and are distinct whenever lx+ly > 2, so the sum of
    the two endpoint costs lower-bounds the path sum (LB_Kim first/last).
  - DFD — the Frechet value is the *max* over an aligning path through the
    same two mandatory cells, so the larger endpoint cost is a bound.
  - ERP — with gap element g = 0, ERP(x, y) >= | sum_i |x_i| - sum_j |y_j| |
    (Chen & Ng, VLDB'04): every edit script pays at least the difference of
    total gap masses.
  - Levenshtein — at least |lx - ly| insertions/deletions are unavoidable.

* **tier 1 — envelope** (O(B*L) elementwise, LB_Keogh lineage): per-window
  upper/lower envelopes (an axis-aligned bounding box per candidate — the
  warping band of our unconstrained alignments is the full sequence, so the
  per-position Keogh envelope degenerates to the per-window box, which is
  exactly what makes it precomputable as two (N, d) arrays on ``FlatNet``).
  See ``lb_dtw_envelope`` / ``lb_erp_envelope`` / ``lb_frechet_envelope``
  for the per-distance soundness proofs.

:class:`EnvelopeSet` holds the precomputed per-window envelope statistics
(box + ERP gap-mass prefix sums), built in ONE vectorized pass by
:func:`build_envelopes`; ``CountedDistance`` caches one per database and
``FlatNet`` stores one for the device / fleet paths.

Signature: ``(xs, ys, len_x, len_y) -> (B,)`` with ``xs: (B, Lx[, d])``,
``ys: (B, Ly[, d])`` and integer length vectors (rows may be padded).
Envelope-tier functions additionally accept ``y_env`` (an
:class:`EnvelopeSet` row-sliced to the batch) so per-candidate statistics
are gathered, never recomputed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

#: tiered LB-cascade policy values (config + engines); the legacy booleans
#: map False -> "off", True -> "endpoint".
LB_TIERS = ("off", "endpoint", "envelope")


def normalize_tier(value) -> str:
    """Map a legacy boolean or a tier name onto ``LB_TIERS``."""
    if value is None or value is False:
        return "off"
    if value is True:
        return "endpoint"
    if value in LB_TIERS:
        return value
    raise ValueError(
        f"lb_cascade must be a bool or one of {LB_TIERS}; got {value!r}")


def _as3d(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return a[..., None] if a.ndim == 2 else a


def _row_norm(a: np.ndarray) -> np.ndarray:
    """(B, L, d) -> (B, L) elementwise L2 magnitudes."""
    return np.sqrt(np.maximum(np.sum(a * a, axis=-1), 0.0))


def _lens(a: np.ndarray, lens) -> np.ndarray:
    if lens is None:
        return np.full(len(a), a.shape[1], np.int64)
    return np.asarray(lens, np.int64)


def _mask(a: np.ndarray, lens: np.ndarray) -> np.ndarray:
    return np.arange(a.shape[1])[None, :] < lens[:, None]


# -- tier 0: endpoint / global-mass bounds ------------------------------------


def _endpoint_costs(xs, ys, len_x, len_y):
    """Costs of the two mandatory alignment cells (1,1) and (lx,ly)."""
    xs, ys = _as3d(xs), _as3d(ys)
    lx = np.asarray(len_x, np.int64)
    ly = np.asarray(len_y, np.int64)
    r = np.arange(len(xs))
    c_first = _row_norm(xs[:, 0] - ys[:, 0])  # (B, d) -> (B,)
    c_last = _row_norm(xs[r, lx - 1] - ys[r, ly - 1])
    return c_first, c_last, lx, ly


def lb_dtw(xs, ys, len_x=None, len_y=None) -> np.ndarray:
    xs, ys = _as3d(xs), _as3d(ys)
    len_x = np.full(len(xs), xs.shape[1]) if len_x is None else len_x
    len_y = np.full(len(ys), ys.shape[1]) if len_y is None else len_y
    c0, ce, lx, ly = _endpoint_costs(xs, ys, len_x, len_y)
    return np.where(lx + ly > 2, c0 + ce, c0).astype(np.float32)


def lb_frechet(xs, ys, len_x=None, len_y=None) -> np.ndarray:
    xs, ys = _as3d(xs), _as3d(ys)
    len_x = np.full(len(xs), xs.shape[1]) if len_x is None else len_x
    len_y = np.full(len(ys), ys.shape[1]) if len_y is None else len_y
    c0, ce, _, _ = _endpoint_costs(xs, ys, len_x, len_y)
    return np.maximum(c0, ce).astype(np.float32)


def lb_erp(xs, ys, len_x=None, len_y=None, *, y_mass=None) -> np.ndarray:
    """| total gap mass of x − total gap mass of y | (Chen & Ng).

    ``y_mass`` optionally carries precomputed per-row candidate gap masses
    (``EnvelopeSet.mass`` gathered by candidate id) so the O(B*L) candidate
    row norms are paid once per database, not once per frontier round.
    """
    xs = _as3d(xs)
    lx = np.full(len(xs), xs.shape[1]) if len_x is None else np.asarray(len_x)
    sx = np.sum(np.where(_mask(xs, np.asarray(lx, np.int64)),
                         _row_norm(xs), 0.0), axis=1)
    if y_mass is not None:
        sy = np.asarray(y_mass, np.float32)
    else:
        ys = _as3d(ys)
        ly = np.full(len(ys), ys.shape[1]) if len_y is None \
            else np.asarray(len_y)
        sy = np.sum(np.where(_mask(ys, np.asarray(ly, np.int64)),
                             _row_norm(ys), 0.0), axis=1)
    return np.abs(sx - sy).astype(np.float32)


def lb_levenshtein(xs, ys, len_x=None, len_y=None) -> np.ndarray:
    xs, ys = np.asarray(xs), np.asarray(ys)
    lx = np.full(len(xs), xs.shape[1]) if len_x is None else np.asarray(len_x)
    ly = np.full(len(ys), ys.shape[1]) if len_y is None else np.asarray(len_y)
    return np.abs(lx - ly).astype(np.float32)


# -- precomputed per-window envelope statistics -------------------------------


@dataclasses.dataclass
class EnvelopeSet:
    """Per-window envelope statistics, one row per database window.

    ``lo``/``hi`` are the per-dimension envelope (axis-aligned bounding box
    over the window's valid positions — the LB_Keogh U/L envelope of an
    unconstrained warping band), ``mass`` the ERP total gap mass
    ``sum_j ||y_j||`` and ``cum`` its prefix sums (leading zero, so
    ``cum[i, m]`` is the gap mass of window i's first m elements)."""

    lo: np.ndarray      # (N, d)
    hi: np.ndarray      # (N, d)
    mass: np.ndarray    # (N,)
    cum: np.ndarray     # (N, L+1)
    lens: np.ndarray    # (N,)

    def take(self, idxs) -> "EnvelopeSet":
        idxs = np.asarray(idxs, np.int64)
        return EnvelopeSet(self.lo[idxs], self.hi[idxs], self.mass[idxs],
                           self.cum[idxs], self.lens[idxs])

    def extend(self, other: "EnvelopeSet") -> "EnvelopeSet":
        """Append rows in place (incremental ``FlatNet.append`` refresh)."""
        W = max(self.cum.shape[1], other.cum.shape[1])

        def padc(c):
            # prefix masses are monotone; edge-padding keeps cum[m] valid
            # (and m > len is masked out of every refinement anyway)
            return np.pad(c, ((0, 0), (0, W - c.shape[1])), mode="edge")

        self.lo = np.concatenate([self.lo, other.lo])
        self.hi = np.concatenate([self.hi, other.hi])
        self.mass = np.concatenate([self.mass, other.mass])
        self.cum = np.concatenate([padc(self.cum), padc(other.cum)])
        self.lens = np.concatenate([self.lens, other.lens])
        return self


def build_envelopes(data: np.ndarray, lens=None) -> EnvelopeSet:
    """ONE stacked vectorized pass over the whole window database."""
    a = _as3d(data)
    ln = _lens(a, lens)
    m = _mask(a, ln)[..., None]
    big = np.float32(3.4e38)
    lo = np.where(m, a, big).min(axis=1)
    hi = np.where(m, a, -big).max(axis=1)
    g = np.where(m[..., 0], _row_norm(a), 0.0)
    cum = np.concatenate(
        [np.zeros((len(a), 1), np.float32), np.cumsum(g, axis=1)],
        axis=1).astype(np.float32)
    return EnvelopeSet(lo.astype(np.float32), hi.astype(np.float32),
                       cum[np.arange(len(a)), ln].astype(np.float32),
                       cum, ln)


def _box_gap(xs3: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(B, L, d) x (B, d) box -> (B, L) distance of each position to the box.

    For any point y inside the box, ``||x_i - y|| >= boxdist(x_i)``: per
    dimension the residual is at least the distance to the box interval,
    and the L2 norm is monotone per coordinate."""
    below = np.maximum(lo[:, None, :] - xs3, 0.0)
    above = np.maximum(xs3 - hi[:, None, :], 0.0)
    g = below + above  # at most one of the two is nonzero per dim
    return np.sqrt(np.maximum(np.sum(g * g, axis=-1), 0.0))


def _y_box(ys3, my, y_env: Optional[EnvelopeSet]):
    if y_env is not None:
        return y_env.lo, y_env.hi
    big = np.float32(3.4e38)
    m = my[..., None]
    return (np.where(m, ys3, big).min(axis=1),
            np.where(m, ys3, -big).max(axis=1))


# -- tier 1: envelope bounds --------------------------------------------------


def lb_dtw_envelope(xs, ys, len_x=None, len_y=None, *,
                    y_env: Optional[EnvelopeSet] = None) -> np.ndarray:
    """LB_Keogh-style envelope bound for (unconstrained) DTW.

    Soundness: DTW(x, y) is the sum of cell costs ``||x_i - y_j||`` along a
    monotone warping path that visits every index i of x at least once (and
    every j of y).  Hence

        DTW(x, y) >= sum_i  min_j ||x_i - y_j||
                  >= sum_i  boxdist(x_i, box(y)),

    since every y_j lies inside box(y) = [lo, hi]^d (the Keogh U/L envelope
    — with no warping-window constraint the envelope of every position is
    the whole sequence's box) and ``||x_i - y_j|| >= boxdist(x_i, box(y))``
    (:func:`_box_gap`).  The symmetric direction holds by the same argument
    with roles swapped, so the max of the two is a valid lower bound.
    """
    xs3, ys3 = _as3d(xs), _as3d(ys)
    lx, ly = _lens(xs3, len_x), _lens(ys3, len_y)
    mx, my = _mask(xs3, lx), _mask(ys3, ly)
    lo_y, hi_y = _y_box(ys3, my, y_env)
    d1 = np.sum(_box_gap(xs3, lo_y, hi_y) * mx, axis=1)
    big = np.float32(3.4e38)
    m = mx[..., None]
    lo_x = np.where(m, xs3, big).min(axis=1)
    hi_x = np.where(m, xs3, -big).max(axis=1)
    d2 = np.sum(_box_gap(ys3, lo_x, hi_x) * my, axis=1)
    return np.maximum(d1, d2).astype(np.float32)


def lb_frechet_envelope(xs, ys, len_x=None, len_y=None, *,
                        y_env: Optional[EnvelopeSet] = None) -> np.ndarray:
    """Envelope analogue for the discrete Frechet distance.

    Soundness: DFD(x, y) is the *max* of cell costs over a coupling that
    visits every index of both curves, so

        DFD(x, y) >= max_i min_j ||x_i - y_j|| >= max_i boxdist(x_i, box(y))

    (every y_j is inside box(y); see :func:`_box_gap`), and symmetrically
    for y against box(x); the max of the two directions is a valid bound.
    """
    xs3, ys3 = _as3d(xs), _as3d(ys)
    lx, ly = _lens(xs3, len_x), _lens(ys3, len_y)
    mx, my = _mask(xs3, lx), _mask(ys3, ly)
    lo_y, hi_y = _y_box(ys3, my, y_env)
    d1 = np.max(np.where(mx, _box_gap(xs3, lo_y, hi_y), 0.0), axis=1)
    big = np.float32(3.4e38)
    m = mx[..., None]
    lo_x = np.where(m, xs3, big).min(axis=1)
    hi_x = np.where(m, xs3, -big).max(axis=1)
    d2 = np.max(np.where(my, _box_gap(ys3, lo_x, hi_x), 0.0), axis=1)
    return np.maximum(d1, d2).astype(np.float32)


def lb_erp_envelope(xs, ys, len_x=None, len_y=None, *,
                    y_env: Optional[EnvelopeSet] = None) -> np.ndarray:
    """Envelope + per-prefix gap-mass refinement for ERP (gap g = 0).

    Two independent sound bounds, combined by max:

    1. *Element consumption*: an ERP edit script consumes each x_i exactly
       once — matched to some y_j (cost ``||x_i - y_j||``) or to a gap
       (cost ``||x_i||``).  Each element's one term is therefore at least
       ``min(||x_i||, min_j ||x_i - y_j||) >=
       min(||x_i||, boxdist(x_i, box(y)))``, and distinct x_i contribute
       distinct cost terms, so the sum over i is a lower bound.  The
       symmetric direction (each y_j consumed exactly once) holds the same
       way; a matched pair's cost is shared between the directions, so the
       two sums may NOT be added — their max is taken instead.

    2. *Per-prefix gap-mass refinement*: fix k = lx // 2.  Any edit script
       splits at the point where x's prefix x[:k] has been consumed,
       inducing a split y[:m] / y[m:] for some 0 <= m <= ly; its cost is
       the cost of a valid script for (x[:k], y[:m]) plus one for the
       suffixes, each of which is >= the gap-mass difference of its halves
       (bound 0 applied to the sub-script, i.e. the triangle inequality
       against the empty sequence).  Minimizing over the unknown m:

           ERP(x, y) >= min_m [ |G_x(k) - G_y(m)|
                                + |(T_x - G_x(k)) - (T_y - G_y(m))| ]

       with G the prefix gap masses and T the totals.  Each term of the
       min is >= |T_x - T_y| (triangle inequality on reals), so this
       refinement dominates the tier-0 global-mass bound — and is strictly
       tighter whenever no prefix mass G_y(m) falls between G_x(k) and
       T_y - (T_x - G_x(k)).

    ``y_env`` supplies precomputed candidate prefix masses
    (``EnvelopeSet.cum`` / ``mass``), so the refinement costs one gather
    plus O(B*L) elementwise work and no recomputed norms.
    """
    xs3, ys3 = _as3d(xs), _as3d(ys)
    lx, ly = _lens(xs3, len_x), _lens(ys3, len_y)
    mx, my = _mask(xs3, lx), _mask(ys3, ly)
    B = len(xs3)
    r = np.arange(B)

    gx = np.where(mx, _row_norm(xs3), 0.0)
    lo_y, hi_y = _y_box(ys3, my, y_env)
    cons_x = np.sum(np.minimum(gx, _box_gap(xs3, lo_y, hi_y)) * mx, axis=1)

    gy = np.where(my, _row_norm(ys3), 0.0)
    big = np.float32(3.4e38)
    m = mx[..., None]
    lo_x = np.where(m, xs3, big).min(axis=1)
    hi_x = np.where(m, xs3, -big).max(axis=1)
    cons_y = np.sum(np.minimum(gy, _box_gap(ys3, lo_x, hi_x)) * my, axis=1)

    # prefix refinement at k = lx // 2
    Gx = np.concatenate([np.zeros((B, 1), np.float32),
                         np.cumsum(gx, axis=1)], axis=1)
    Tx = Gx[r, lx]
    if y_env is not None:
        Gy, Ty = y_env.cum, y_env.mass
    else:
        Gy = np.concatenate([np.zeros((B, 1), np.float32),
                             np.cumsum(gy, axis=1)], axis=1)
        Ty = Gy[r, ly]
    a = Gx[r, lx // 2]
    b = Tx - a
    f = (np.abs(a[:, None] - Gy)
         + np.abs(b[:, None] - (Ty[:, None] - Gy)))
    valid_m = np.arange(Gy.shape[1])[None, :] <= ly[:, None]
    prefix = np.min(np.where(valid_m, f, np.inf), axis=1)

    return np.maximum(np.maximum(cons_x, cons_y),
                      prefix).astype(np.float32)


def lb_envelope_rows(name: str, xs, len_x, lo, hi, mass) -> np.ndarray:
    """One-direction envelope bound from PRECOMPUTED candidate envelopes.

    The gathered-statistics form used where candidate rows may not be
    materialized host-side (the fleet round engine and the device query
    path): only direction 1 of the two-sided envelope bounds above — query
    positions against each candidate's stored box — plus, for ERP, the
    tier-0 global-mass bound from the stored masses.  Each term is one of
    the sound bounds proved in the two-sided functions, so the result is a
    valid lower bound (just a looser one than the two-sided max).
    """
    xs3 = _as3d(xs)
    lx = _lens(xs3, len_x)
    mx = _mask(xs3, lx)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    bd = _box_gap(xs3, lo, hi)
    if name == "frechet":
        return np.max(np.where(mx, bd, 0.0), axis=1).astype(np.float32)
    if name == "dtw":
        return np.sum(bd * mx, axis=1).astype(np.float32)
    if name == "erp":
        gx = np.where(mx, _row_norm(xs3), 0.0)
        cons = np.sum(np.minimum(gx, bd) * mx, axis=1)
        gm = np.abs(gx.sum(axis=1) - np.asarray(mass, np.float32))
        return np.maximum(cons, gm).astype(np.float32)
    raise KeyError(f"no envelope bound for distance {name!r}")
