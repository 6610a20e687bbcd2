"""One kernel registry for every device evaluation path.

* one :class:`KernelSpec` per distance, keyed exactly like the distance
  registry: ``dtw`` / ``erp`` / ``frechet`` / ``levenshtein`` are the
  wavefront modes (the hand-written CUDA kernel of ``kernels/wavefront.py``
  on the card, its plain torch version on the CPU), ``euclidean`` /
  ``hamming`` are elementwise torch;
* fused ε-pruning (Twin Subsequence Search, arXiv:2104.06874): pass
  ``eps`` and the kernel returns the hit mask and early-prune certificate
  alongside ``BIG``-masked distances, so range queries never materialize
  distances for pruned candidates.

The reference's TPU-only machinery has no counterpart here: PyTorch runs
eagerly and the CUDA kernel takes the dispatch's widths as runtime
arguments, so there is no per-shape jit cache, no power-of-two batch
padding to bound recompiles, and no interpret / exec / band-tile policy.
The ``lb:`` envelope specs come with the device LB-envelope slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.distances._wavefront import sum_last
from repro_torch.kernels.wavefront import BIG, wavefront

#: wavefront mode <-> distance-registry name
MODE_OF_NAME = {"dtw": "dtw", "erp": "erp", "frechet": "dfd",
                "levenshtein": "lev"}
NAME_OF_MODE = {v: k for k, v in MODE_OF_NAME.items()}

#: call accounting — ``calls`` increments once per host dispatch
STATS = {"calls": 0}


class KernelOut(NamedTuple):
    """One device evaluation: masked distances + fused-ε masks.

    ``dist`` holds the exact distance for rows whose verdict is a hit (or
    every row when ``eps`` was +inf/None), ``BIG`` otherwise.  ``pruned``
    marks rows certified ``> eps`` before their final diagonal (a subset
    of ``~hit``)."""
    dist: object
    hit: object
    pruned: object


def _cumsum_seq(t: torch.Tensor) -> torch.Tensor:
    """Prefix sums along axis 1, left to right one add at a time — the
    order of numpy's host wavefront on every device (a CUDA scan may
    associate differently)."""
    cols = [t[:, 0]]
    for j in range(1, t.shape[1]):
        cols.append(cols[-1] + t[:, j])
    return torch.stack(cols, dim=1)


def _lengths(lens, B: int, width: int) -> np.ndarray:
    if lens is None:
        return np.full(B, width, np.int64)
    if isinstance(lens, torch.Tensor):
        lens = lens.cpu().numpy()
    return np.asarray(lens, np.int64)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Device evaluation of one registered distance."""

    name: str                 # distance-registry key
    kind: str                 # "wavefront" | "elementwise"
    mode: Optional[str] = None  # wavefront DP mode (dtw/erp/dfd/lev)

    def batch(self, xs, ys, lx=None, ly=None, eps=None, *,
              device=None) -> KernelOut:
        """Row-paired evaluation -> :class:`KernelOut` of tensors.

        ``xs``/``ys`` are ``(B, Lx[, d])`` / ``(B, Ly[, d])`` numpy arrays or
        tensors (integer tokens for the string distances); ``lx``/``ly``
        per-row actual lengths (default: the padded widths), which may mix
        length buckets freely — operands are trimmed to the max actual
        lengths, which become the dispatch's widths; ``eps`` a scalar or
        per-row threshold enabling the fused ε outputs.  Runs on ``device``
        (default: the device of ``ys`` if it is a tensor, else the card):
        the CUDA kernel on a CUDA device, its plain version on the CPU.
        """
        dev = device_mod.of(ys, device)
        B = len(xs)
        if B == 0:
            z = torch.zeros((0,), device=dev)
            return KernelOut(z, z.bool(), z.bool())
        lx_h = _lengths(lx, B, xs.shape[1])
        ly_h = _lengths(ly, B, ys.shape[1])
        if lx is not None:
            xs = xs[:, :max(int(lx_h.max()), 1)]
        if ly is not None:
            ys = ys[:, :max(int(ly_h.max()), 1)]
        xs = device_mod.as_tensor(xs, dev)
        ys = device_mod.as_tensor(ys, dev)
        lx_t = torch.as_tensor(lx_h).to(dev)
        ly_t = torch.as_tensor(ly_h).to(dev)
        if eps is None:
            eps_t = torch.full((B,), float("inf"), device=dev)
        else:
            eps_t = torch.broadcast_to(
                device_mod.as_tensor(eps, dev, torch.float32),
                (B,)).contiguous()
        STATS["calls"] += 1
        if self.kind == "elementwise":
            return self._elementwise(xs, ys, lx_t, eps_t)
        return self._wavefront(xs, ys, lx_t, ly_t, eps_t)

    def _elementwise(self, xs, ys, lx, eps_v) -> KernelOut:
        L = xs.shape[1]
        mask = torch.arange(L, device=xs.device)[None, :] < lx[:, None]
        if self.name == "hamming":
            d = ((xs != ys) & mask).sum(dim=1).to(torch.float32)
        else:  # euclidean
            diff = xs.to(torch.float32) - ys.to(torch.float32)
            d2 = diff * diff
            if d2.ndim == 3:
                d2 = torch.sum(d2, dim=-1)
            d = torch.sqrt(torch.clamp_min((d2 * mask).sum(dim=1), 0.0))
        hit = d <= eps_v
        return KernelOut(torch.where(hit, d, BIG), hit,
                         torch.zeros_like(hit))

    def layout(self, xs, ys, lx, ly):
        """The wavefront operand layout (the reference's
        ``KernelSpec._wavefront`` prep): x shift-padded so position ``i``
        holds ``x[i-1]``; y reversed and padded so diagonal ``k`` reads
        window start ``Lx+1+Ly-k`` (ragged rows keep their zero padding at
        the *front* after the flip — the DP cells that read it never feed
        the answer at ``(len_x, len_y)``); ERP gap costs; ``BIG``-clamped
        border cumsums.  Returns the eight kernel operands (without eps)
        and the dispatch widths ``(Lx, Ly)``."""
        mode = self.mode
        xs = xs.to(torch.float32)  # lev tokens ride as exact small floats
        ys = ys.to(torch.float32)
        if xs.ndim == 2:
            xs, ys = xs[..., None], ys[..., None]
        B, Lx, d = xs.shape
        Ly = ys.shape[1]
        dev = xs.device
        Ypad = 2 * Lx + Ly + 1
        x_pad = torch.zeros((B, Lx + 1, d), device=dev)
        x_pad[:, 1:] = xs
        y_rev_pad = torch.zeros((B, Ypad, d), device=dev)
        y_rev_pad[:, Lx + 1:Lx + 1 + Ly] = ys.flip(1)
        gap_x = torch.zeros((B, Lx + 1), device=dev)
        gap_y_rev = torch.zeros((B, Ypad), device=dev)
        if mode == "erp":
            gx = torch.clamp_max(torch.sqrt(torch.clamp_min(
                sum_last(xs * xs), 0.0)), BIG)
            gy = torch.clamp_max(torch.sqrt(torch.clamp_min(
                sum_last(ys * ys), 0.0)), BIG)
            # zero the padding tail so border cumsums end at (len_x, len_y)
            gx = torch.where(torch.arange(Lx, device=dev)[None, :]
                             < lx[:, None], gx, 0.0)
            gy = torch.where(torch.arange(Ly, device=dev)[None, :]
                             < ly[:, None], gy, 0.0)
            gap_x[:, 1:] = gx
            gap_y_rev[:, Lx + 1:Lx + 1 + Ly] = gy.flip(1)
            zero = torch.zeros((B, 1), device=dev)
            # clamp: a cumsum above the BIG sentinel would corrupt the DP's
            # quasi-infinity ordering (and overflow to inf three adds later)
            border_col = torch.clamp_max(
                torch.cat([zero, _cumsum_seq(gx)], dim=1), BIG)
            border_row = torch.clamp_max(
                torch.cat([zero, _cumsum_seq(gy)], dim=1), BIG)
        elif mode == "lev":
            border_col = torch.arange(Lx + 1, dtype=torch.float32,
                                      device=dev).repeat(B, 1)
            border_row = torch.arange(Ly + 1, dtype=torch.float32,
                                      device=dev).repeat(B, 1)
        else:
            border_col = torch.full((B, Lx + 1), BIG, device=dev)
            border_col[:, 0] = 0.0
            border_row = torch.full((B, Ly + 1), BIG, device=dev)
            border_row[:, 0] = 0.0
        lens = torch.stack([lx, ly], dim=1).to(torch.int32)  # (B, 2)
        return (x_pad, y_rev_pad, gap_x, gap_y_rev, border_col, border_row,
                lens), (Lx, Ly)

    def _wavefront(self, xs, ys, lx, ly, eps_v) -> KernelOut:
        ops, (Lx, Ly) = self.layout(xs, ys, lx, ly)
        dist, hit, pruned = wavefront(*ops, eps_v, mode=self.mode, Lx=Lx,
                                      Ly=Ly)
        return KernelOut(dist, hit, pruned)


_KERNELS: Dict[str, KernelSpec] = {}
for _name, _mode in MODE_OF_NAME.items():
    _KERNELS[_name] = KernelSpec(name=_name, kind="wavefront", mode=_mode)
for _name in ("euclidean", "hamming"):
    _KERNELS[_name] = KernelSpec(name=_name, kind="elementwise")


def has(name: str) -> bool:
    return name in _KERNELS


def get(name: str) -> KernelSpec:
    if name not in _KERNELS:
        raise KeyError(
            f"no device kernel for distance {name!r}; have {sorted(_KERNELS)}")
    return _KERNELS[name]


def spec_for_mode(mode: str) -> KernelSpec:
    """Look up a wavefront spec by DP mode (``dtw``/``erp``/``dfd``/``lev``)."""
    if mode not in NAME_OF_MODE:
        raise KeyError(f"unknown wavefront mode {mode!r}")
    return get(NAME_OF_MODE[mode])

