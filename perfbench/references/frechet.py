"""The discrete Fréchet distance (Eiter and Mannila, 1994) by the textbook
dynamic program, one cell at a time, over a batch of row-aligned pairs of
series windows.

Every operation rounds as the configuration's float32 states: a cell's
cost is the Euclidean norm of the two points' difference, its squares
summed left to right (numpy's order below eight coordinates) and rooted
in float64, whose rounding to float32 is the correctly rounded float32
root; then ``D[i][j] = max(c, min(D[i-1][j], D[i][j-1], D[i-1][j-1]))``,
with the first row and column running maxima of the costs.  Max and min
never round, so only the costs differ between precisions.  The control
runs the same program in bfloat16, the next precision below float32.
"""

from __future__ import annotations

import torch

CONTROL = {"dtype": torch.bfloat16, "strict": False}
DTYPE = torch.float32


def _planes(a: torch.Tensor) -> list:
    """``(P, L, d)`` series as ``d`` contiguous ``(L, P)`` planes, one a
    coordinate, so that a row of the table reads whole planes."""
    return [a[..., k].t().contiguous() for k in range(a.shape[-1])]


def pair_distances(x: torch.Tensor, y: torch.Tensor,
                   dtype: torch.dtype = DTYPE) -> torch.Tensor:
    """``(P,)`` distances of ``x[p]`` to ``y[p]``; ``x`` ``(P, Lx, d)``,
    ``y`` ``(P, Ly, d)``."""
    if x.shape[-1] >= 8:
        raise ValueError("the left-to-right sum is numpy's order only "
                         "below eight coordinates")
    xs, ys = _planes(x.to(dtype)), _planes(y.to(dtype))
    Lx, Ly = x.shape[1], y.shape[1]
    # one row of the table at a time, (Ly, P); buffers reused across rows
    v, s, c = (torch.empty_like(ys[0]) for _ in range(3))
    root = torch.empty(ys[0].shape, dtype=torch.float64,
                       device=ys[0].device)
    m = torch.empty_like(ys[0][0])
    prev, cur = torch.empty_like(c), torch.empty_like(c)
    for i in range(Lx):
        # row i's costs: squares summed left to right, rooted in float64
        for k, (xk, yk) in enumerate(zip(xs, ys)):
            torch.sub(xk[i], yk, out=v)
            if k == 0:
                torch.mul(v, v, out=s)
            else:
                s.add_(v.mul_(v))
        root.copy_(s).sqrt_()
        c.copy_(root)
        if i == 0:              # the first row: a running maximum
            cur[0] = c[0]
            for j in range(1, Ly):
                torch.maximum(c[j], cur[j - 1], out=cur[j])
        else:
            torch.maximum(c[0], prev[0], out=cur[0])
            for j in range(1, Ly):
                torch.minimum(cur[j - 1], prev[j - 1], out=m)
                torch.minimum(prev[j], m, out=m)
                torch.maximum(c[j], m, out=cur[j])
        prev, cur = cur, prev
    return prev[Ly - 1].clone()
