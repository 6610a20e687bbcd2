"""Discrete Frechet distance (Eiter & Mannila 1994).

Metric and consistent (paper §4): the max-of-couplings alignment distance.
"""

from __future__ import annotations

import torch

from repro_torch.distances import base, bounds
from repro_torch.distances._wavefront import (
    BIG, l2_cost, matrixify, prepare, wavefront_dp)


def _combine(c, c_du, c_dl, dd, du, dl):
    return torch.maximum(c, torch.minimum(dd, torch.minimum(du, dl)))


def frechet_batch(xs, ys, len_x=None, len_y=None, device=None):
    xs, ys, lx, ly = prepare(xs, ys, len_x, len_y, device, torch.float32)
    B, Lx, Ly = xs.shape[0], xs.shape[1], ys.shape[1]
    cost = l2_cost(xs, ys)
    col = torch.full((B, Lx + 1), BIG, device=xs.device)
    col[:, 0] = 0.0
    row = torch.full((B, Ly + 1), BIG, device=xs.device)
    row[:, 0] = 0.0
    return wavefront_dp(cost, _combine, col, row, lx, ly)


frechet = base.register(base.Distance(
    name="frechet",
    batch=frechet_batch,
    matrix=matrixify(frechet_batch),
    metric=True,
    consistent=True,
    string=False,
    variable_length=True,
    doc="Discrete Frechet distance (DFD); metric",
    lower_bound=bounds.lb_frechet,
    envelope_bound=bounds.lb_frechet_envelope,
))
