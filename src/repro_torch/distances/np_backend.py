"""Numpy wavefront backend for *host-mode* index traversal.

The reference net / cover tree / MV index are host-side control structures
(paper §6, Appendix); their candidate batches are small (tens) and arrive
sequentially, where per-call device dispatch overhead would dominate.
This module evaluates the same anti-diagonal recurrences in numpy.  It is
tested against the same row-major oracles as the torch engine; the device
(GPU) path uses the CUDA wavefront kernel instead.
"""

from __future__ import annotations

import numpy as np

BIG = np.float32(3.4e37)


def _l2_cost(xs, ys):
    diff = xs[:, :, None, :] - ys[:, None, :, :]
    return np.sqrt(np.maximum(np.sum(diff * diff, axis=-1), 0.0))


def _neq_cost(xs, ys):
    return (xs[:, :, None] != ys[:, None, :]).astype(np.float32)


def batch_alignment(xs: np.ndarray, ys: np.ndarray, mode: str,
                    len_x=None, len_y=None) -> np.ndarray:
    """(B, Lx[, d]) x (B, Ly[, d]) -> (B,) alignment distances, numpy."""
    if mode == "lev":
        xs = np.asarray(xs)
        ys = np.asarray(ys)
        cost = _neq_cost(xs, ys)
    else:
        xs = np.asarray(xs, np.float32)
        ys = np.asarray(ys, np.float32)
        if xs.ndim == 2:
            xs, ys = xs[..., None], ys[..., None]
        cost = _l2_cost(xs, ys)
    B, Lx, Ly = cost.shape
    len_x = np.full(B, Lx) if len_x is None else np.asarray(len_x)
    len_y = np.full(B, Ly) if len_y is None else np.asarray(len_y)

    if mode == "erp":
        gx = np.sqrt(np.maximum(np.sum(xs * xs, -1), 0.0))
        gy = np.sqrt(np.maximum(np.sum(ys * ys, -1), 0.0))
        pos_x = np.arange(Lx)[None, :] < len_x[:, None]
        pos_y = np.arange(Ly)[None, :] < len_y[:, None]
        gx = np.where(pos_x, gx, 0.0)
        gy = np.where(pos_y, gy, 0.0)
        border_col = np.concatenate(
            [np.zeros((B, 1), np.float32), np.cumsum(gx, 1)], 1)
        border_row = np.concatenate(
            [np.zeros((B, 1), np.float32), np.cumsum(gy, 1)], 1)
    elif mode == "lev":
        border_col = np.broadcast_to(
            np.arange(Lx + 1, dtype=np.float32)[None], (B, Lx + 1)).copy()
        border_row = np.broadcast_to(
            np.arange(Ly + 1, dtype=np.float32)[None], (B, Ly + 1)).copy()
        gx = gy = None
    else:
        border_col = np.full((B, Lx + 1), BIG, np.float32)
        border_col[:, 0] = 0.0
        border_row = np.full((B, Ly + 1), BIG, np.float32)
        border_row[:, 0] = 0.0
        gx = gy = None

    ii = np.arange(Lx + 1)
    d1 = np.full((B, Lx + 1), BIG, np.float32)
    d1[:, 0] = border_col[:, 0]
    d2 = np.full((B, Lx + 1), BIG, np.float32)
    res = np.where(len_x + len_y == 0, d1[:, 0], BIG).astype(np.float32)
    target = len_x + len_y
    rows = np.arange(B)

    for k in range(1, Lx + Ly + 1):
        ci = ii - 1
        cj = k - ii - 1
        valid = (ci >= 0) & (cj >= 0) & (ci < Lx) & (cj < Ly)
        c = np.zeros((B, Lx + 1), np.float32)
        c[:, valid] = cost[:, ci[valid], cj[valid]]
        dd = np.concatenate([np.full((B, 1), BIG, np.float32), d2[:, :-1]], 1)
        du = np.concatenate([np.full((B, 1), BIG, np.float32), d1[:, :-1]], 1)
        dl = d1
        if mode == "dtw":
            new = c + np.minimum(dd, np.minimum(du, dl))
        elif mode == "dfd":
            new = np.maximum(c, np.minimum(dd, np.minimum(du, dl)))
        elif mode == "lev":
            new = np.minimum(dd + c, np.minimum(du + 1.0, dl + 1.0))
        else:  # erp
            cu = np.concatenate([np.zeros((B, 1), np.float32), gx], 1)
            cl = np.zeros((B, Lx + 1), np.float32)
            vj = (cj >= 0) & (cj < Ly)
            cl[:, vj] = gy[:, cj[vj]]
            new = np.minimum(dd + c, np.minimum(du + cu, dl + cl))
        if k <= Lx:
            new[:, k] = border_col[:, k]
        new[:, 0] = border_row[:, k] if k <= Ly else BIG
        new[:, (ii > k) | (ii < k - Ly)] = BIG
        hit = target == k
        if hit.any():
            res[hit] = new[rows[hit], len_x[hit]]
        d2 = d1
        d1 = new
    return res


def batch_euclidean(xs, ys, len_x=None, len_y=None):
    xs = np.asarray(xs, np.float32)
    ys = np.asarray(ys, np.float32)
    if xs.ndim == 2:
        xs, ys = xs[..., None], ys[..., None]
    B, L = xs.shape[0], xs.shape[1]
    lx = np.full(B, L) if len_x is None else np.asarray(len_x)
    mask = (np.arange(L)[None, :] < lx[:, None]).astype(np.float32)
    d2 = np.sum(np.sum((xs - ys) ** 2, -1) * mask, -1)
    return np.sqrt(np.maximum(d2, 0.0))


def batch_hamming(xs, ys, len_x=None, len_y=None):
    xs, ys = np.asarray(xs), np.asarray(ys)
    B, L = xs.shape
    lx = np.full(B, L) if len_x is None else np.asarray(len_x)
    mask = np.arange(L)[None, :] < lx[:, None]
    return np.sum((xs != ys) & mask, -1).astype(np.float32)


_MODE_OF = {"dtw": "dtw", "erp": "erp", "frechet": "dfd", "levenshtein": "lev"}


def batch_for(name: str):
    """Numpy batch function matching a registry distance name."""
    if name == "euclidean":
        return batch_euclidean
    if name == "hamming":
        return batch_hamming
    if name in _MODE_OF:
        mode = _MODE_OF[name]
        return lambda xs, ys, lx=None, ly=None: batch_alignment(
            xs, ys, mode, lx, ly)
    raise KeyError(name)


def matrix_for(name: str):
    """Numpy all-pairs function with the registry ``matrix`` signature.

    Completes host-side parity with ``Distance.batch``/``Distance.matrix``:
    (M, Lx[, d]) x (N, Ly[, d]) -> (M, N), realized by tiling into one
    paired batch so the wavefront runs once over all M*N cells.
    """
    batch = batch_for(name)

    def matrix(xs, ys, len_x=None, len_y=None):
        xs, ys = np.asarray(xs), np.asarray(ys)
        M, N = len(xs), len(ys)
        xt = np.repeat(xs, N, axis=0)
        yt = np.tile(ys, (M,) + (1,) * (ys.ndim - 1))
        lx = None if len_x is None else np.repeat(np.asarray(len_x), N)
        ly = None if len_y is None else np.tile(np.asarray(len_y), M)
        return batch(xt, yt, lx, ly).reshape(M, N)

    return matrix
