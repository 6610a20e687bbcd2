"""Levenshtein distance by the textbook dynamic program, one row of the
table at a time, over a batch of row-aligned pairs of token windows.

Distances are whole numbers, computed in int32; no precision is stated
that a lower one could break.  The control therefore breaks the
configuration's guarantee instead: it answers ``d < eps`` where the
guarantee is every window with ``d <= eps`` (a boundary that an
optimisation of the pruning could tempt a later change to lose).
"""

from __future__ import annotations

import torch

#: the control: the strict boundary, in the reference's own precision
CONTROL = {"dtype": torch.int32, "strict": True}
DTYPE = torch.int32


def pair_distances(x: torch.Tensor, y: torch.Tensor,
                   dtype: torch.dtype = DTYPE) -> torch.Tensor:
    """``(P,)`` distances of ``x[p]`` to ``y[p]``; ``x`` ``(P, Lx)``,
    ``y`` ``(P, Ly)`` integer tokens."""
    P, Lx = x.shape
    Ly = y.shape[1]
    prev = torch.arange(Ly + 1, dtype=dtype, device=x.device).expand(
        P, Ly + 1).clone()
    for i in range(1, Lx + 1):
        cur = torch.empty_like(prev)
        cur[:, 0] = i
        xi = x[:, i - 1]
        for j in range(1, Ly + 1):
            sub = prev[:, j - 1] + (xi != y[:, j - 1]).to(dtype)
            cur[:, j] = torch.minimum(
                sub, torch.minimum(prev[:, j], cur[:, j - 1]) + 1)
        prev = cur
    return prev[:, Ly]
