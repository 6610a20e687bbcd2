"""Dynamic Time Warping.

Consistent (paper §4) but NOT metric (paper §3.3/§5): usable with the
segmentation filter + linear scan, rejected by the metric indexes.
"""

from __future__ import annotations

import torch

from repro_torch.distances import base, bounds
from repro_torch.distances._wavefront import (
    BIG, l2_cost, matrixify, prepare, wavefront_dp)


def _combine(c, c_du, c_dl, dd, du, dl):
    return c + torch.minimum(dd, torch.minimum(du, dl))


def dtw_batch(xs, ys, len_x=None, len_y=None, device=None):
    xs, ys, lx, ly = prepare(xs, ys, len_x, len_y, device, torch.float32)
    B, Lx, Ly = xs.shape[0], xs.shape[1], ys.shape[1]
    cost = l2_cost(xs, ys)
    col = torch.full((B, Lx + 1), BIG, device=xs.device)
    col[:, 0] = 0.0
    row = torch.full((B, Ly + 1), BIG, device=xs.device)
    row[:, 0] = 0.0
    return wavefront_dp(cost, _combine, col, row, lx, ly)


dtw = base.register(base.Distance(
    name="dtw",
    batch=dtw_batch,
    matrix=matrixify(dtw_batch),
    metric=False,
    consistent=True,
    string=False,
    variable_length=True,
    doc="Dynamic Time Warping; element cost = Euclidean",
    lower_bound=bounds.lb_dtw,
    envelope_bound=bounds.lb_dtw_envelope,
))
