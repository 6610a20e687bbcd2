"""Frozen copy of the port's roofline yardstick for the wavefront kernel.

Copied verbatim from ``src/repro_torch/roofline/costs.py`` (the H100 peaks
at ``:31``-``:44``; ``bytes_ms`` ``:59``, ``_numel`` ``:64``, ``_np`` ``:68``,
``wavefront_cost`` ``:74``), so that a later change to the program cannot
move the bound a kernel's time is held to.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: H100 SXM data-sheet peaks (NVIDIA; dense, without sparsity, at 700 W).
#: f32 outside the tensor cores (an FMA counts as two operations)
PEAK_F32_FLOPS = 67e12
#: operations that are not fused multiply-adds (adds, mins, compares, abs)
#: issue at most once per lane per clock: 132 SMs x 128 lanes x 1.98 GHz
#: (boost clock)
PEAK_F32_OPS = 132 * 128 * 1.98e9
#: TF32 and bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
#: HBM3 rate and size
PEAK_BYTES = 3.35e12


def bytes_ms(nbytes: float) -> float:
    """Milliseconds to move ``nbytes`` at the HBM rate."""
    return nbytes / PEAK_BYTES * 1e3


def _numel(a) -> int:
    return a.numel() if isinstance(a, torch.Tensor) else int(np.size(a))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def wavefront_cost(mode: str, xs, ys, lx, ly, eps) -> Dict:
    """Cost of the alignment function of one wavefront dispatch:
    ``{ops, bytes, bound_ms, bound_by, old_bound_ms}``.

    Bytes: x and y at the dispatch's widths (f32 tokens or series, or int32
    ids), the two lengths (int32), eps (f32), each read once, and dist
    (f32), hit and pruned (bool) written once.  Operations, per cell of
    each row's own ``len_x x len_y`` (those the function cannot do without
    on any input):

    * cost: lev one compare of two tokens; float modes d subtracts,
      d multiplies, d - 1 adds, the sqrt and its BIG clamp (the max with 0
      of a sum of squares changes nothing);
    * combine: dtw and dfd 3 (two mins and an add or max), erp 5 (three
      adds, two mins), lev 4 (min(du + 1, dl + 1) == min(du, dl) + 1: an
      add and a min are enough for the two);
    * the BIG clamp of the sum: dtw and erp 1; dfd and lev 0 (no operand
      exceeds BIG, and BIG + 1 rounds to BIG);
    * the certificate, on rows with finite eps only (+inf rows can never
      be pruned): 1, a running minimum of the new diagonal (the previous
      diagonal's minimum is carried);

    and for erp per element of the row's own lengths its gap (d multiplies,
    d - 1 adds, sqrt, clamp) and border sum (an add and a clamp).  None is a
    fused multiply-add, so they count against :data:`PEAK_F32_OPS`.
    ``old_bound_ms`` is the earlier count (lev cost 3 ops, float cost
    3d + 2, the clamp in every mode and two for the certificate on every
    row) over :data:`PEAK_F32_FLOPS`, which counts each of these operations
    as half an FMA."""
    B = xs.shape[0]
    d = 1 if mode == "lev" else xs.shape[2]
    nbytes = 4 * (_numel(xs) + _numel(ys)) + B * (2 * 4 + 4) \
        + B * (4 + 1 + 1)
    lx, ly = _np(lx), _np(ly)
    finite = np.isfinite(_np(eps))
    cost = 1 if mode == "lev" else 3 * d + 1
    comb = {"dtw": 3, "dfd": 3, "erp": 5, "lev": 4}[mode]
    clamp = 1 if mode in ("dtw", "erp") else 0
    cells = float(np.sum(lx * ly))
    ops = cells * (cost + comb + clamp) + float(np.sum((lx * ly)[finite]))
    if mode == "erp":
        ops += float(np.sum(lx + ly)) * (2 * d + 3)
    t_bytes = bytes_ms(nbytes)
    t_ops = ops / PEAK_F32_OPS * 1e3
    old_ops = cells * ((3 * d if mode == "lev" else 3 * d + 2)
                       + (3 if mode in ("dtw", "dfd") else 5) + 1 + 2)
    old = max(t_bytes, old_ops / PEAK_F32_FLOPS * 1e3)
    by_bytes = t_bytes >= t_ops
    return {"ops": ops, "bytes": float(nbytes),
            "bound_ms": t_bytes if by_bytes else t_ops,
            "bound_by": "bytes" if by_bytes else "operations",
            "old_bound_ms": old}
