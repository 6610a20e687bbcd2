"""Anti-diagonal wavefront evaluation of alignment DPs (DTW/ERP/DFD/Levenshtein).

The four alignment distances used by the paper share one dynamic program over
an (Lx+1) x (Ly+1) table D, where D[i, j] relates prefixes x[:i] and y[:j].
They differ only in

* the border values D[i, 0], D[0, j],
* the cell ``combine`` rule.

A CPU implementation walks the table row-major; that serialises every cell.
Here the table is swept along **anti-diagonals**: diagonal k = i + j depends
only on diagonals k-1 and k-2, so each of the Lx+Ly steps is one vectorised
(B, Lx+1) min/add over the whole batch of DP problems.  This module is the
plain torch engine behind the registry's ``batch``/``matrix`` functions (the
``torch`` counter backend); the hand-written CUDA kernel in
``repro_torch.kernels.wavefront`` runs the same schedule with the cost
computed on the fly.

Variable lengths are supported by padding to a common (Lx, Ly) and reading
the answer off diagonal len_x + len_y at position len_x.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch import device as device_mod

BIG = 3.4e37  # quasi-infinity that survives adds without overflowing f32


# ---------------------------------------------------------------------------
# numpy's orders of float32 sums and its correctly rounded square root
# ---------------------------------------------------------------------------
#
# The reference's host lane (``distances/np_backend.py``, ``bounds.py``)
# sums float32 last axes with numpy's ``pairwise_sum`` and takes
# ``np.sqrt``, which is correctly rounded.  Every float distance of the
# port uses the helpers below on every device, so it equals that lane bit
# for bit and a range query at an ε set at a distance goes the same way.

#: leaves of numpy's pairwise sum hold at most this many terms
_PW_BLOCK = 128


@functools.lru_cache(maxsize=None)
def _pw_plan(n: int):
    """numpy's ``pairwise_sum`` order over ``n > 128`` terms: the sum of
    the first ``m = n // 2 - (n // 2) % 8`` terms plus the sum of the
    rest, each split again until its leaf holds at most 128 terms.
    Returns ``(runs, tree)``: ``runs`` the leaves left to right as maximal
    runs ``(start, count, k)`` of ``k`` adjacent leaves of ``count``
    terms each, ``tree`` the splits as nested pairs of leaf indices."""
    leaves = []

    def plan(start: int, count: int):
        if count <= _PW_BLOCK:
            leaves.append((start, count))
            return len(leaves) - 1
        m = count // 2
        m -= m % 8
        return (plan(start, m), plan(start + m, count - m))

    tree = plan(0, n)
    runs = []
    for start, count in leaves:
        if runs and runs[-1][1] == count \
                and runs[-1][0] + count * runs[-1][2] == start:
            runs[-1] = (runs[-1][0], count, runs[-1][2] + 1)
        else:
            runs.append((start, count, 1))
    return tuple(runs), tree


def _pw_leaf(t: torch.Tensor) -> torch.Tensor:
    """numpy's sum of the ``n <= 128`` terms of the last axis: left to
    right below 8; else eight running sums over the blocks of 8 (term
    ``j`` of every block into sum ``j``), joined as ``((r0 + r1) + (r2 +
    r3)) + ((r4 + r5) + (r6 + r7))``, then the ``n % 8`` tail left to
    right."""
    n = t.shape[-1]
    if n < 8:
        acc = t[..., 0]
        for i in range(1, n):
            acc = acc + t[..., i]
        return acc
    body = n - n % 8
    r = t[..., 0:8]
    for i in range(8, body, 8):
        r = r + t[..., i:i + 8]
    r = r[..., 0::2] + r[..., 1::2]        # r0+r1, r2+r3, r4+r5, r6+r7
    r = r[..., 0::2] + r[..., 1::2]
    acc = r[..., 0] + r[..., 1]
    for i in range(body, n):
        acc = acc + t[..., i]
    return acc


def sum_last(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's ``pairwise_sum`` order (what
    ``np.sum(a, axis=-1)`` does on a float32 array), every add a separate
    float32 rounding, vectorised over the leading axes and over adjacent
    leaves of one size; the order is planned once per length.  The same
    plain torch ops on every device (a library reduction may associate
    differently)."""
    n = t.shape[-1]
    if n <= _PW_BLOCK:
        return _pw_leaf(t)
    runs, tree = _pw_plan(n)
    leaves = []
    for start, count, k in runs:
        sums = _pw_leaf(t[..., start:start + count * k].unflatten(
            -1, (k, count)))
        leaves.extend(sums[..., i] for i in range(k))

    def join(node):
        if isinstance(node, int):
            return leaves[node]
        return join(node[0]) + join(node[1])

    return join(tree)


def cumsum_seq(t: torch.Tensor) -> torch.Tensor:
    """Prefix sums along axis 1, left to right one add at a time: what
    ``np.cumsum(a, axis=1)`` does (``torch.cumsum`` may associate
    differently, on the CPU as on the card)."""
    cols = [t[:, 0]]
    for j in range(1, t.shape[1]):
        cols.append(cols[-1] + t[:, j])
    return torch.stack(cols, dim=1)


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as ``np.sqrt`` gives it: the
    root is taken in float64 (53 bits, more than 2 * 24 + 2, so the one
    rounding to float32 is exact) whatever the device's own float32
    ``sqrt`` does."""
    return torch.sqrt(t.double()).float()


def _diag_gather(flat: torch.Tensor, k: int, ii: torch.Tensor, Lx: int,
                 Ly: int) -> torch.Tensor:
    """Gather cost[b, i-1, k-i-1] for each diagonal position i in ``ii``
    from the ``(B, Lx*Ly)`` flattened cost tile.

    Entries falling outside the Lx x Ly cost tile are returned as 0 (they are
    masked out of the DP by the border/validity logic).
    """
    ci = ii - 1
    cj = k - ii - 1
    valid = (ci >= 0) & (cj >= 0) & (ci < Lx) & (cj < Ly)
    idx = ci.clamp(0, Lx - 1) * Ly + cj.clamp(0, Ly - 1)
    return torch.where(valid[None, :], flat[:, idx], 0.0)


def _shift_right(v: torch.Tensor) -> torch.Tensor:
    """v[i] -> v[i-1], injecting the BIG sentinel at i = 0."""
    return torch.cat([torch.full_like(v[:, :1], BIG), v[:, :-1]], dim=1)


def wavefront_dp(
    cost: torch.Tensor,
    combine: Callable,
    border_col: torch.Tensor,
    border_row: torch.Tensor,
    len_x: torch.Tensor,
    len_y: torch.Tensor,
    gap_x: Optional[torch.Tensor] = None,
    gap_y: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the generic wavefront DP.

    Args:
      cost:       (B, Lx, Ly) elementwise cost tile c(x_i, y_j).
      combine:    f(c, c_du, c_dl, dd, du, dl) -> new cell value, where
                  dd = D[i-1,j-1], du = D[i-1,j], dl = D[i,j-1].
      border_col: (B, Lx+1) with border_col[:, i] = D[i, 0].
      border_row: (B, Ly+1) with border_row[:, j] = D[0, j].
      len_x/len_y: (B,) int actual lengths (len_x <= Lx, len_y <= Ly).
      gap_x:      (B, Lx) optional per-element gap cost for the du move (ERP).
      gap_y:      (B, Ly) optional per-element gap cost for the dl move (ERP).

    Returns:
      (B,) final D[len_x, len_y] per batch element.
    """
    B, Lx, Ly = cost.shape
    dev = cost.device
    ii = torch.arange(Lx + 1, device=dev)
    len_x = len_x.to(device=dev, dtype=torch.int64)
    target = len_x + len_y.to(device=dev, dtype=torch.int64)
    flat = cost.reshape(B, Lx * Ly)

    d1 = torch.full((B, Lx + 1), BIG, dtype=cost.dtype, device=dev)
    d1[:, 0] = border_col[:, 0]
    d2 = torch.full((B, Lx + 1), BIG, dtype=cost.dtype, device=dev)
    # answer for degenerate len_x = len_y = 0 lives on diagonal 0
    res = torch.where(target == 0, d1[:, 0], BIG)

    # the du-move gap cost is indexed by diagonal position only: pos i uses
    # gap_x[i-1] (independent of k)
    c_du = None
    if gap_x is not None:
        c_du = torch.cat([torch.zeros_like(gap_x[:, :1]), gap_x], dim=1)

    for k in range(1, Lx + Ly + 1):
        c = _diag_gather(flat, k, ii, Lx, Ly)
        dd = _shift_right(d2)
        du = _shift_right(d1)
        dl = d1
        c_dl = None
        if gap_y is not None:
            # gap_y gathered along the diagonal: position i -> gap_y[k-i-1]
            cj = k - ii - 1
            validj = (cj >= 0) & (cj < Ly)
            c_dl = torch.where(validj[None, :],
                               gap_y[:, cj.clamp(0, Ly - 1)], 0.0)
        new = combine(c, c_du, c_dl, dd, du, dl)
        # clamp: sums involving the BIG sentinel (or extreme gap-mass
        # borders) must stay at BIG, never overflow to float32 inf/NaN —
        # BIG's ordering against real values is what masks cells
        new = torch.clamp_max(new, BIG)
        # borders: i = k is column j = 0; i = 0 is row j = k
        if k <= Lx:
            new[:, k] = border_col[:, k]
        new[:, 0] = border_row[:, k] if k <= Ly else BIG
        # mask positions outside the valid band i in [max(0, k-Ly), min(k, Lx)]
        new[:, (ii > k) | (ii < k - Ly)] = BIG
        # record the answer when this diagonal holds it
        val = new.gather(1, len_x[:, None])[:, 0]
        res = torch.where(target == k, val, res)
        d2, d1 = d1, new
    return res


# ---------------------------------------------------------------------------
# Cost tiles
# ---------------------------------------------------------------------------

def l2_cost(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(B,Lx,d),(B,Ly,d) -> (B,Lx,Ly) pairwise Euclidean element cost."""
    diff = xs[:, :, None, :] - ys[:, None, :, :]
    return sqrt_rn(torch.clamp_min(sum_last(diff * diff), 0.0))


def neq_cost(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(B,Lx),(B,Ly) int tokens -> (B,Lx,Ly) 0/1 substitution cost."""
    return (xs[:, :, None] != ys[:, None, :]).to(torch.float32)


def prepare(xs, ys, len_x, len_y, device, dtype):
    """Common argument handling of the ``*_batch`` functions: tensors on one
    device, series lifted to ``(B, L, d)``, and per-row lengths
    (default: the padded widths)."""
    dev = device_mod.of(xs, device)
    xs = device_mod.as_tensor(xs, dev, dtype)
    ys = device_mod.as_tensor(ys, dev, dtype)
    if dtype == torch.float32 and xs.ndim == 2:  # scalar series -> (B, L, 1)
        xs, ys = xs[..., None], ys[..., None]
    lx = default_lengths(xs, len_x, dev)
    ly = default_lengths(ys, len_y, dev)
    return xs, ys, lx, ly


def default_lengths(xs: torch.Tensor, len_x, device) -> torch.Tensor:
    B, L = xs.shape[0], xs.shape[1]
    if len_x is None:
        return torch.full((B,), L, dtype=torch.int64, device=device)
    return device_mod.as_tensor(len_x, device, torch.int64)


def matrixify(batch_fn):
    """Lift a paired batch distance to an all-pairs (M, N) matrix."""

    def matrix(xs, ys, len_x=None, len_y=None, device=None):
        dev = device_mod.of(xs, device)
        xs = device_mod.as_tensor(xs, dev)
        ys = device_mod.as_tensor(ys, dev)
        M, N = xs.shape[0], ys.shape[0]
        lx = default_lengths(xs, len_x, dev)
        ly = default_lengths(ys, len_y, dev)
        xs_b = xs.repeat_interleave(N, dim=0)
        ys_b = ys.repeat((M,) + (1,) * (ys.ndim - 1))
        lx_b = lx.repeat_interleave(N)
        ly_b = ly.repeat(M)
        return batch_fn(xs_b, ys_b, lx_b, ly_b).reshape(M, N)

    return matrix
