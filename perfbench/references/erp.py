"""ERP (edit distance with real penalty; Chen and Ng, VLDB 2004) by the
textbook dynamic program, one cell at a time, over a batch of row-aligned
pairs of series windows, with the gap element g = 0.

Every operation rounds as the configuration's float32 states, in the
order the definition gives: a cell's cost is the square root of the sum of
squared coordinate differences (summed left to right, which is numpy's
order below eight coordinates), rounded once to float32 (the root is taken
in float64, whose rounding to float32 is the correctly rounded float32
root); each candidate of a cell is one float32 addition; the borders are
running sums of the gap costs.  The control runs the same program in
bfloat16, the next precision below float32.
"""

from __future__ import annotations

import torch

CONTROL = {"dtype": torch.bfloat16, "strict": False}
DTYPE = torch.float32


def _norm(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Euclidean norm over the last axis, summed left to right."""
    if v.shape[-1] >= 8:
        raise ValueError("the left-to-right sum is numpy's order only "
                         "below eight coordinates")
    sq = v * v
    s = sq[..., 0]
    for k in range(1, v.shape[-1]):
        s = s + sq[..., k]
    return torch.sqrt(s.double()).to(dtype)


def pair_distances(x: torch.Tensor, y: torch.Tensor,
                   dtype: torch.dtype = DTYPE) -> torch.Tensor:
    """``(P,)`` distances of ``x[p]`` to ``y[p]``; ``x`` ``(P, Lx, d)``,
    ``y`` ``(P, Ly, d)``."""
    x, y = x.to(dtype), y.to(dtype)
    Lx, Ly = x.shape[1], y.shape[1]
    gx, gy = _norm(x, dtype), _norm(y, dtype)
    prev = [torch.zeros(x.shape[0], dtype=dtype, device=x.device)]
    for j in range(1, Ly + 1):
        prev.append(prev[j - 1] + gy[:, j - 1])
    for i in range(1, Lx + 1):
        cur = [prev[0] + gx[:, i - 1]]
        for j in range(1, Ly + 1):
            c = _norm(x[:, i - 1] - y[:, j - 1], dtype)
            cur.append(torch.minimum(
                prev[j - 1] + c,
                torch.minimum(prev[j] + gx[:, i - 1],
                              cur[j - 1] + gy[:, j - 1])))
        prev = cur
    return prev[Ly]
