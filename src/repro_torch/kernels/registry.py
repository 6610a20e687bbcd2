"""One kernel registry for every device evaluation path.

* one :class:`KernelSpec` per distance, keyed exactly like the distance
  registry: ``dtw`` / ``erp`` / ``frechet`` / ``levenshtein`` are the
  wavefront modes (the hand-written CUDA kernel of ``kernels/wavefront.py``
  on the card, its plain torch version on the CPU), ``euclidean`` /
  ``hamming`` are elementwise torch, and one ``lb:<name>`` envelope spec
  per alignment distance with an envelope bound (``dtw`` / ``erp`` /
  ``frechet``) is the LB-cascade tier-1 bound: O(B*L) elementwise torch
  ops on the operands' device (the reference's is jnp, not Pallas);
* fused ε-pruning (Twin Subsequence Search, arXiv:2104.06874): pass
  ``eps`` and the kernel returns the hit mask and early-prune certificate
  alongside ``BIG``-masked distances, so range queries never materialize
  distances for pruned candidates.

The reference's TPU-only machinery has no counterpart here: PyTorch runs
eagerly and the CUDA kernel takes the dispatch's widths as runtime
arguments, so there is no per-shape jit cache, no power-of-two batch
padding to bound recompiles, and no interpret / exec / band-tile policy.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels.wavefront import BIG, lev_operand, wavefront

#: wavefront mode <-> distance-registry name
MODE_OF_NAME = {"dtw": "dtw", "erp": "erp", "frechet": "dfd",
                "levenshtein": "lev"}
NAME_OF_MODE = {v: k for k, v in MODE_OF_NAME.items()}

#: call accounting — ``calls`` increments once per host dispatch (under
#: :data:`_STATS_LOCK`: a serving thread and a resharding thread dispatch
#: at once)
STATS = {"calls": 0}
_STATS_LOCK = threading.Lock()

#: the envelope specs' box sentinel (the reference's ``3.4e38``)
ENV_BIG = 3.4e38


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


def _lens_tensor(lx, ly, B: int, Lx: int, Ly: int,
                 dev: torch.device) -> torch.Tensor:
    """``(B, 2)`` int32 ``(len_x, len_y)`` on ``dev``: one host-to-device
    copy when both are host arrays, stacked on the device otherwise."""
    if isinstance(lx, torch.Tensor) or isinstance(ly, torch.Tensor):
        cols = [torch.full((B,), W, dtype=torch.int32, device=dev)
                if v is None else device_mod.as_tensor(v, dev, torch.int32)
                for v, W in ((lx, Lx), (ly, Ly))]
        return torch.stack(cols, dim=1).contiguous()
    return torch.as_tensor(np.stack([_lengths(lx, B, Lx),
                                     _lengths(ly, B, Ly)], axis=1)
                           .astype(np.int32)).to(dev)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Device evaluation of one registered distance."""

    name: str                 # distance-registry key (``lb:<name>``)
    kind: str                 # "wavefront" | "elementwise" | "envelope"
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
            return self.device_call(xs, ys, device=dev)
        lx_h = _lengths(lx, B, xs.shape[1])
        ly_h = _lengths(ly, B, ys.shape[1])
        if lx is not None:
            xs = xs[:, :max(int(lx_h.max()), 1)]
        if ly is not None:
            ys = ys[:, :max(int(ly_h.max()), 1)]
        with _STATS_LOCK:
            STATS["calls"] += 1
        return self.device_call(xs, ys, lx_h, ly_h, eps, device=dev)

    def device_call(self, xs, ys, lx=None, ly=None, eps=None, *,
                    device=None) -> KernelOut:
        """The evaluation itself, at the operands' widths as given (no
        trimming — the reference's ``device_call``, which its one-shot
        fleet query composes; ``lx``/``ly`` numpy arrays or tensors, None
        for the full widths)."""
        dev = device_mod.of(ys, device)
        B = len(xs)
        if B == 0:
            z = torch.zeros((0,), device=dev)
            return KernelOut(z, z.bool(), z.bool())
        if self.mode == "lev":  # int32 ids, range-checked
            xs, ys = lev_operand(xs, dev), lev_operand(ys, dev)
        else:
            xs = device_mod.as_tensor(xs, dev)
            ys = device_mod.as_tensor(ys, dev)
        if eps is None:
            eps_t = torch.full((B,), float("inf"), device=dev)
        else:
            eps_t = torch.broadcast_to(
                device_mod.as_tensor(eps, dev, torch.float32),
                (B,)).contiguous()
        lens = _lens_tensor(lx, ly, B, xs.shape[1], ys.shape[1], dev)
        if self.kind == "elementwise":
            return self._elementwise(xs, ys, lens[:, 0], eps_t)
        if self.kind == "envelope":
            return self._envelope(xs, ys, lens[:, 0], lens[:, 1], eps_t)
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

    def _envelope(self, xs, ys, lx, ly, eps_v) -> KernelOut:
        """LB-cascade tier-1 envelope bound (O(B*L) elementwise).

        The device mirror of ``distances/bounds.py``'s two-sided envelope
        bounds (soundness proofs live there): per-row axis-aligned boxes
        over the valid positions, per-position box distances, and the
        mode-specific combine — sum (dtw), max (dfd), or the ERP element
        consumption + prefix gap-mass refinement.  ``dist`` carries the
        bound itself (never BIG-masked — pruned rows return their bound so
        callers keep the ``<= eps`` verdict); ``pruned`` certifies
        ``lb > eps``, i.e. the exact wavefront DP can be skipped."""
        xs = xs.to(torch.float32)
        ys = ys.to(torch.float32)
        if xs.ndim == 2:
            xs, ys = xs[..., None], ys[..., None]
        B, Lx, _ = xs.shape
        Ly = ys.shape[1]
        dev = xs.device
        lx = lx.to(torch.int64)
        ly = ly.to(torch.int64)
        mx = torch.arange(Lx, device=dev)[None, :] < lx[:, None]
        my = torch.arange(Ly, device=dev)[None, :] < ly[:, None]
        lo_y = torch.where(my[..., None], ys, ENV_BIG).amin(dim=1)
        hi_y = torch.where(my[..., None], ys, -ENV_BIG).amax(dim=1)
        lo_x = torch.where(mx[..., None], xs, ENV_BIG).amin(dim=1)
        hi_x = torch.where(mx[..., None], xs, -ENV_BIG).amax(dim=1)

        def box_gap(a, lo, hi):
            g = torch.clamp_min(lo[:, None, :] - a, 0.0) \
                + torch.clamp_min(a - hi[:, None, :], 0.0)
            return torch.sqrt(torch.clamp_min((g * g).sum(dim=-1), 0.0))

        bdx = box_gap(xs, lo_y, hi_y)          # (B, Lx)
        bdy = box_gap(ys, lo_x, hi_x)          # (B, Ly)
        if self.mode == "dfd":
            lb = torch.maximum(torch.where(mx, bdx, 0.0).amax(dim=1),
                               torch.where(my, bdy, 0.0).amax(dim=1))
        elif self.mode == "dtw":
            lb = torch.maximum((bdx * mx).sum(dim=1), (bdy * my).sum(dim=1))
        else:  # erp
            gx = torch.where(mx, torch.sqrt(torch.clamp_min(
                (xs * xs).sum(dim=-1), 0.0)), 0.0)
            gy = torch.where(my, torch.sqrt(torch.clamp_min(
                (ys * ys).sum(dim=-1), 0.0)), 0.0)
            cons = torch.maximum(
                (torch.minimum(gx, bdx) * mx).sum(dim=1),
                (torch.minimum(gy, bdy) * my).sum(dim=1))
            z = torch.zeros((B, 1), device=dev)
            Gx = torch.cat([z, torch.cumsum(gx, dim=1)], dim=1)
            Gy = torch.cat([z, torch.cumsum(gy, dim=1)], dim=1)
            Tx = Gx.gather(1, lx[:, None])[:, 0]
            Ty = Gy.gather(1, ly[:, None])[:, 0]
            a = Gx.gather(1, (lx // 2)[:, None])[:, 0]
            b = Tx - a
            f = (a[:, None] - Gy).abs() \
                + (b[:, None] - (Ty[:, None] - Gy)).abs()
            valid_m = torch.arange(Ly + 1,
                                   device=dev)[None, :] <= ly[:, None]
            lb = torch.maximum(cons, torch.where(
                valid_m, f, float("inf")).amin(dim=1))
        hit = lb <= eps_v
        return KernelOut(lb, hit, ~hit)

    def _wavefront(self, xs, ys, lens, eps_v) -> KernelOut:
        """The operands go to :func:`~repro_torch.kernels.wavefront.wavefront`
        as the dispatch trimmed them: the kernel builds borders, gaps and
        costs on chip (the plain version first builds the reference's padded
        layout).  Series ride as f32 ``(B, L, d)``, as in the reference;
        Levenshtein tokens ``(B, L)`` as int32 ids
        (:func:`~repro_torch.kernels.wavefront.lev_operand`, applied by
        :meth:`device_call`, a no-op on operands already int32), where the
        reference casts them to f32 and rounds ids of ``2**24`` and above
        together."""
        if self.mode != "lev":
            xs, ys = xs.to(torch.float32), ys.to(torch.float32)
            if xs.ndim == 2:
                xs, ys = xs[..., None], ys[..., None]
        dist, hit, pruned = wavefront(xs.contiguous(), ys.contiguous(), lens,
                                      eps_v, mode=self.mode)
        return KernelOut(dist, hit, pruned)


_KERNELS: Dict[str, KernelSpec] = {}
for _name, _mode in MODE_OF_NAME.items():
    _KERNELS[_name] = KernelSpec(name=_name, kind="wavefront", mode=_mode)
for _name in ("euclidean", "hamming"):
    _KERNELS[_name] = KernelSpec(name=_name, kind="elementwise")
# LB-cascade tier-1 envelope specs: one per alignment distance with an
# envelope bound (levenshtein's length bound is already exact at tier 0,
# and token boxes are meaningless — no lb:levenshtein)
for _name in ("dtw", "erp", "frechet"):
    _KERNELS[f"lb:{_name}"] = KernelSpec(
        name=f"lb:{_name}", kind="envelope", mode=MODE_OF_NAME[_name])


def has(name: str) -> bool:
    return name in _KERNELS


def has_envelope(name: str) -> bool:
    """Whether distance ``name`` has a device tier-1 envelope spec."""
    return f"lb:{name}" in _KERNELS


def get_envelope(name: str) -> KernelSpec:
    return get(f"lb:{name}")


def takes_token_ids(name: str) -> bool:
    """Whether distance ``name``'s kernel takes its operands as int32 token
    ids (:func:`~repro_torch.kernels.wavefront.lev_operand`): tables that
    feed it are converted, and range-checked, once where they are built."""
    return name in _KERNELS and _KERNELS[name].mode == "lev"


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


def names():
    return sorted(_KERNELS)
