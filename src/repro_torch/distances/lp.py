"""Euclidean and Hamming distances (equal-length, no alignment).

Both are metric and consistent (paper §4) but cannot tolerate temporal
misalignment — the paper notes this makes them a poor fit for subsequence
matching with shifts (§5); they remain first-class citizens here because the
embedding-retrieval integration uses Euclidean over fixed-length hidden-state
windows, where lengths always agree.
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.distances import base
from repro_torch.distances._wavefront import (
    default_lengths, matrixify, prepare, sqrt_rn, sum_last)


def euclidean_batch(xs, ys, len_x=None, len_y=None, device=None):
    xs, ys, lx, _ = prepare(xs, ys, len_x, len_y, device, torch.float32)
    L = xs.shape[1]
    mask = (torch.arange(L, device=xs.device)[None, :]
            < lx[:, None]).to(torch.float32)
    diff = xs - ys
    # numpy's batch_euclidean: the d-sum, masked, then the L-sum
    d2 = sum_last(sum_last(diff * diff) * mask)
    return sqrt_rn(torch.clamp_min(d2, 0.0))


def euclidean_matrix(xs, ys, len_x=None, len_y=None, device=None):
    """All-pairs Euclidean via the ||x||^2 + ||y||^2 - 2 x.y identity."""
    dev = device_mod.of(xs, device)
    xs = device_mod.as_tensor(xs, dev, torch.float32)
    ys = device_mod.as_tensor(ys, dev, torch.float32)
    xf = xs.reshape(xs.shape[0], -1)
    yf = ys.reshape(ys.shape[0], -1)
    xn = (xf * xf).sum(dim=1)
    yn = (yf * yf).sum(dim=1)
    d2 = xn[:, None] + yn[None, :] - 2.0 * (xf @ yf.T)
    return sqrt_rn(torch.clamp_min(d2, 0.0))


def hamming_batch(xs, ys, len_x=None, len_y=None, device=None):
    dev = device_mod.of(xs, device)
    xs = device_mod.as_tensor(xs, dev, torch.int64)
    ys = device_mod.as_tensor(ys, dev, torch.int64)
    L = xs.shape[1]
    lx = default_lengths(xs, len_x, dev)
    mask = torch.arange(L, device=dev)[None, :] < lx[:, None]
    return ((xs != ys) & mask).sum(dim=-1).to(torch.float32)


euclidean = base.register(base.Distance(
    name="euclidean",
    batch=euclidean_batch,
    matrix=euclidean_matrix,
    metric=True,
    consistent=True,
    string=False,
    variable_length=False,
    doc="L2 over equal-length sequences; metric",
))

hamming = base.register(base.Distance(
    name="hamming",
    batch=hamming_batch,
    matrix=matrixify(hamming_batch),
    metric=True,
    consistent=True,
    string=True,
    variable_length=False,
    doc="Hamming over equal-length token sequences; metric",
))
