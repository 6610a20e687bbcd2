"""Plain torch oracles for the hand-written kernels (tests and
``chip_smoke.py`` only).

``wavefront_ref`` evaluates the fixed-length batched alignment DP that the
wavefront kernel computes through the generic anti-diagonal engine of
``repro_torch.distances._wavefront`` (itself held against row-major numpy
oracles), so the chain is numpy row-major DP == torch wavefront engine ==
CUDA kernel.  ``pairwise_l2_ref`` is the direct difference form of the
distance matrix in float64, independent of the norm-and-dot identity that
both the kernel and its plain version use.
"""

from __future__ import annotations

import torch

from repro_torch.distances._wavefront import (BIG, cumsum_seq, l2_cost,
                                              neq_cost, sqrt_rn, sum_last,
                                              wavefront_dp)

MODES = ("dtw", "erp", "dfd", "lev")


def _combine_for(mode):
    if mode == "dtw":
        return lambda c, cu, cl, dd, du, dl: c + torch.minimum(
            dd, torch.minimum(du, dl))
    if mode == "erp":
        return lambda c, cu, cl, dd, du, dl: torch.minimum(
            dd + c, torch.minimum(du + cu, dl + cl))
    if mode == "dfd":
        return lambda c, cu, cl, dd, du, dl: torch.maximum(
            c, torch.minimum(dd, torch.minimum(du, dl)))
    if mode == "lev":
        return lambda c, cu, cl, dd, du, dl: torch.minimum(
            dd + c, torch.minimum(du + 1.0, dl + 1.0))
    raise ValueError(mode)


def prepare(xs: torch.Tensor, ys: torch.Tensor, mode: str):
    """Cost tile, borders and (erp) gap vectors of a fixed-length batch."""
    if mode == "lev":
        B, Lx = xs.shape
        Ly = ys.shape[1]
        cost = neq_cost(xs, ys)
        border_col = torch.arange(Lx + 1, dtype=torch.float32,
                                  device=xs.device).expand(B, Lx + 1)
        border_row = torch.arange(Ly + 1, dtype=torch.float32,
                                  device=xs.device).expand(B, Ly + 1)
        return cost, border_col, border_row, None, None
    xs = xs.to(torch.float32)
    ys = ys.to(torch.float32)
    if xs.ndim == 2:
        xs, ys = xs[..., None], ys[..., None]
    B, Lx, Ly = xs.shape[0], xs.shape[1], ys.shape[1]
    cost = torch.clamp_max(l2_cost(xs, ys), BIG)
    if mode == "erp":
        # gaps and border cumsums clamp at BIG, as in the kernel
        gap_x = torch.clamp_max(sqrt_rn(torch.clamp_min(
            sum_last(xs * xs), 0.0)), BIG)
        gap_y = torch.clamp_max(sqrt_rn(torch.clamp_min(
            sum_last(ys * ys), 0.0)), BIG)
        zero = torch.zeros((B, 1), device=xs.device)
        border_col = torch.clamp_max(
            torch.cat([zero, cumsum_seq(gap_x)], dim=1), BIG)
        border_row = torch.clamp_max(
            torch.cat([zero, cumsum_seq(gap_y)], dim=1), BIG)
        return cost, border_col, border_row, gap_x, gap_y
    border_col = torch.full((B, Lx + 1), BIG, device=xs.device)
    border_col[:, 0] = 0.0
    border_row = torch.full((B, Ly + 1), BIG, device=xs.device)
    border_row[:, 0] = 0.0
    return cost, border_col, border_row, None, None


def wavefront_ref(xs: torch.Tensor, ys: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """(B, L[, d]) x (B, L[, d]) -> (B,) full-length alignment distance."""
    if mode not in MODES:
        raise ValueError(f"unknown wavefront mode {mode!r}")
    cost, bc, br, gx, gy = prepare(xs, ys, mode)
    B, Lx, Ly = cost.shape
    lx = torch.full((B,), Lx, dtype=torch.int64, device=cost.device)
    ly = torch.full((B,), Ly, dtype=torch.int64, device=cost.device)
    return wavefront_dp(cost, _combine_for(mode), bc, br, lx, ly,
                        gap_x=gx, gap_y=gy)


def pairwise_l2_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, d) x (N, d) -> (M, N) f32 distances, summed as squared
    differences in float64 (an (M, N, d) intermediate: small inputs
    only)."""
    x = x.to(torch.float64)
    y = y.to(torch.float64)
    diff = x[:, None, :] - y[None, :, :]
    return torch.sqrt((diff * diff).sum(-1)).to(torch.float32)
