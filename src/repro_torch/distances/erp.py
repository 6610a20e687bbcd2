"""ERP — Edit distance with Real Penalty (Chen & Ng, VLDB'04).

Metric AND consistent: the paper's recommended time-series distance for the
indexed path (§5).  Gap element g defaults to the origin.
"""

from __future__ import annotations

import torch

from repro_torch.distances import base, bounds
from repro_torch.distances._wavefront import (
    cumsum_seq, l2_cost, matrixify, prepare, sqrt_rn, sum_last, wavefront_dp)


def _combine(c, c_du, c_dl, dd, du, dl):
    return torch.minimum(dd + c, torch.minimum(du + c_du, dl + c_dl))


def erp_batch(xs, ys, len_x=None, len_y=None, device=None):
    xs, ys, lx, ly = prepare(xs, ys, len_x, len_y, device, torch.float32)
    B, Lx, Ly = xs.shape[0], xs.shape[1], ys.shape[1]
    dev = xs.device
    cost = l2_cost(xs, ys)
    # gap cost: distance of each element to the gap element g = 0
    gap_x = sqrt_rn(torch.clamp_min(sum_last(xs * xs), 0.0))  # (B, Lx)
    gap_y = sqrt_rn(torch.clamp_min(sum_last(ys * ys), 0.0))  # (B, Ly)
    # mask padding out of the cumulative borders
    gap_x = torch.where(torch.arange(Lx, device=dev)[None, :] < lx[:, None],
                        gap_x, 0.0)
    gap_y = torch.where(torch.arange(Ly, device=dev)[None, :] < ly[:, None],
                        gap_y, 0.0)
    zero = torch.zeros((B, 1), device=dev)
    border_col = torch.cat([zero, cumsum_seq(gap_x)], dim=1)
    border_row = torch.cat([zero, cumsum_seq(gap_y)], dim=1)
    return wavefront_dp(cost, _combine, border_col, border_row, lx, ly,
                        gap_x=gap_x, gap_y=gap_y)


erp = base.register(base.Distance(
    name="erp",
    batch=erp_batch,
    matrix=matrixify(erp_batch),
    metric=True,
    consistent=True,
    string=False,
    variable_length=True,
    doc="Edit distance with Real Penalty; gap element g = 0; metric",
    lower_bound=bounds.lb_erp,
    envelope_bound=bounds.lb_erp_envelope,
))
