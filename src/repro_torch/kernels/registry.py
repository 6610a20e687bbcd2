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
        if eps is None:
            eps_t = torch.full((B,), float("inf"), device=dev)
        else:
            eps_t = torch.broadcast_to(
                device_mod.as_tensor(eps, dev, torch.float32),
                (B,)).contiguous()
        STATS["calls"] += 1
        if self.kind == "elementwise":
            return self._elementwise(xs, ys, torch.as_tensor(lx_h).to(dev),
                                     eps_t)
        lens = torch.as_tensor(np.stack([lx_h, ly_h], axis=1)
                               .astype(np.int32)).to(dev)  # one copy
        return self._wavefront(xs, ys, lens, eps_t)

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

    def _wavefront(self, xs, ys, lens, eps_v) -> KernelOut:
        """The operands go to :func:`~repro_torch.kernels.wavefront.wavefront`
        as the dispatch trimmed them: the kernel builds borders, gaps and
        costs on chip (the plain version first builds the reference's padded
        layout).  Everything rides as f32, as in the reference: Levenshtein
        tokens of any dtype ``(B, L)``, series ``(B, L, d)``."""
        xs, ys = xs.to(torch.float32), ys.to(torch.float32)
        if self.mode != "lev" and xs.ndim == 2:
            xs, ys = xs[..., None], ys[..., None]
        dist, hit, pruned = wavefront(xs.contiguous(), ys.contiguous(), lens,
                                      eps_v, mode=self.mode)
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

