"""Levenshtein (edit) distance over integer token sequences.

Metric and consistent (paper §4): the paper's string-database distance.
"""

from __future__ import annotations

import torch

from repro_torch.distances import base, bounds
from repro_torch.distances._wavefront import (
    matrixify, neq_cost, prepare, wavefront_dp)


def _combine(c, c_du, c_dl, dd, du, dl):
    return torch.minimum(dd + c, torch.minimum(du + 1.0, dl + 1.0))


def levenshtein_batch(xs, ys, len_x=None, len_y=None, device=None):
    xs, ys, lx, ly = prepare(xs, ys, len_x, len_y, device, torch.int64)
    B, Lx, Ly = xs.shape[0], xs.shape[1], ys.shape[1]
    dev = xs.device
    cost = neq_cost(xs, ys)
    col = torch.arange(Lx + 1, dtype=torch.float32, device=dev).expand(B, -1)
    row = torch.arange(Ly + 1, dtype=torch.float32, device=dev).expand(B, -1)
    return wavefront_dp(cost, _combine, col, row, lx, ly)


levenshtein = base.register(base.Distance(
    name="levenshtein",
    batch=levenshtein_batch,
    matrix=matrixify(levenshtein_batch),
    metric=True,
    consistent=True,
    string=True,
    variable_length=True,
    doc="Levenshtein / edit distance over token ids; metric",
    lower_bound=bounds.lb_levenshtein,
))
