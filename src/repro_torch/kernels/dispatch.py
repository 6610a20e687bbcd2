"""Packed ragged-bucket dispatch: one device call per frontier round.

The matching layer buckets query segments by length (§5: there are only
``2*lambda_0 + 1`` lengths).  The packed dispatcher folds a round's work
across **all** buckets into one padded call:

* rows are segment-sorted by their ``(len_x, len_y)`` bucket (stable), so
  equal shapes sit contiguously and the bucket layout is deterministic;
* the bucket offsets of the sorted layout are recorded as static metadata
  (:class:`PackedMeta`) — diagnostics for the benchmarks and the hook for a
  future per-bucket grid split;
* operands are padded to the round's maximum lengths and handed to the
  kernel registry in ONE call (one kernel launch on the card); per-row
  actual lengths ride along, so the ragged wavefront kernel reads each
  row's answer off its own diagonal;
* results are scattered back to the caller's row order.

Candidate rows may arrive as a tensor already on the device (the counter
gathers them there from its window table); query rows and the per-row
lengths come from the host.  Eval accounting stays with
:class:`~repro_torch.core.counter.CountedDistance`, which counts requested
rows only.

:data:`STATS` tracks what per-bucket dispatch would have cost
(``bucket_rounds``) against what packing actually paid (``dispatches``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import registry


@dataclasses.dataclass(frozen=True)
class PackedMeta:
    """Static layout of one packed dispatch (sorted by bucket)."""
    #: ``(len_x, len_y, count)`` per contiguous bucket, in sorted order
    buckets: Tuple[Tuple[int, int, int], ...]
    #: row offset of each bucket in the sorted layout
    offsets: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


@dataclasses.dataclass
class DispatchStats:
    """Cumulative packed-dispatch accounting (benchmarks read this)."""
    dispatches: int = 0     # packed device calls actually issued
    bucket_rounds: int = 0  # calls a per-bucket dispatcher would have issued
    rows: int = 0           # requested rows (excl. any padding)
    pruned: int = 0         # rows certified > eps before their last diagonal
    last_meta: Optional[PackedMeta] = None

    def reset(self) -> None:
        self.dispatches = 0
        self.bucket_rounds = 0
        self.rows = 0
        self.pruned = 0
        self.last_meta = None


STATS = DispatchStats()


def pad_ragged_rows(rows):
    """Stack ragged rows into a zero-padded ``(N, W[, d])`` array.

    Returns ``(padded, lengths)`` — the one ragged-batch layout every
    packed caller (engine, fleet serving) shares."""
    lens = np.array([len(r) for r in rows], np.int64)
    out = np.zeros((len(rows), int(lens.max())) + rows[0].shape[1:],
                   rows[0].dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, lens


def pack_meta(lx: np.ndarray, ly: np.ndarray
              ) -> Tuple[np.ndarray, PackedMeta]:
    """Stable bucket sort of rows by ``(len_x, len_y)``.

    Returns the sort order plus the static bucket metadata of the sorted
    layout."""
    order = np.lexsort((ly, lx))
    slx, sly = lx[order], ly[order]
    buckets, offsets = [], []
    start = 0
    for i in range(1, len(order) + 1):
        if i == len(order) or slx[i] != slx[start] or sly[i] != sly[start]:
            buckets.append((int(slx[start]), int(sly[start]), i - start))
            offsets.append(start)
            start = i
    return order, PackedMeta(tuple(buckets), tuple(offsets))


def packed_batch(name: str, xs, ys, lx=None, ly=None, *, eps=None,
                 device=None) -> registry.KernelOut:
    """ONE padded device call over every length bucket of a round.

    ``xs``/``ys`` are row-paired batches (numpy arrays or tensors) whose
    rows may come from different ``(len_x, len_y)`` buckets (``lx``/``ly``
    carry the actual lengths); ``eps`` (scalar or per-row; +inf rows opt
    out) enables fused ε-pruning.  Runs on ``device`` (default: the device
    of ``ys`` if it is a tensor, else the card).  Results come back in the
    caller's row order as numpy arrays.  (The reference's per-row fleet
    ``shards`` provenance comes with the fleet slice.)
    """
    spec = registry.get(name)
    dev = device_mod.of(ys, device)
    B = len(xs)
    if B == 0:
        z = np.zeros((0,), np.float32)
        return registry.KernelOut(z, z.astype(bool), z.astype(bool))
    lx = np.full(B, xs.shape[1], np.int64) if lx is None \
        else np.asarray(lx, np.int64)
    ly = np.full(B, ys.shape[1], np.int64) if ly is None \
        else np.asarray(ly, np.int64)
    eps_v = None if eps is None else \
        np.broadcast_to(np.asarray(eps, np.float32), (B,))

    order, meta = pack_meta(lx, ly)
    xs_sorted = np.asarray(xs)[order] if not isinstance(xs, torch.Tensor) \
        else xs[torch.as_tensor(order, device=xs.device)]
    ys_sorted = np.asarray(ys)[order] if not isinstance(ys, torch.Tensor) \
        else ys[torch.as_tensor(order, device=ys.device)]
    out = spec.batch(xs_sorted, ys_sorted, lx[order], ly[order],
                     eps=None if eps_v is None else eps_v[order], device=dev)

    inv = np.empty_like(order)
    inv[order] = np.arange(B)
    inv_t = torch.as_tensor(inv, device=dev)
    result = registry.KernelOut(out.dist[inv_t].cpu().numpy(),
                                out.hit[inv_t].cpu().numpy(),
                                out.pruned[inv_t].cpu().numpy())

    STATS.dispatches += 1
    STATS.bucket_rounds += meta.n_buckets
    STATS.rows += B
    STATS.pruned += int(result.pruned.sum())
    STATS.last_meta = meta
    return result
