"""Batched anti-diagonal wavefront alignment DP: the hand-written CUDA kernel
and its plain torch version.

This is the paper's compute hot spot (§5/§7 steps 2 and 4: every index-build
pair and every query segment against every surviving database window goes
through an O(l^2) alignment DP).  It replaces the Pallas TPU kernel
``src/repro/kernels/wavefront.py:wavefront_pallas`` and computes the same
function on the same padded operand layout (prepared by
``kernels/registry.py``):

* diagonal ``k = i + j`` of the DP table depends only on diagonals ``k-1``
  and ``k-2``, so the ``Lx + Ly`` steps each update one ``(B, Lx+1)``
  diagonal;
* each cell's cost is computed on the fly from ``x_pad`` (position ``i``
  holds ``x[i-1]``) and a reversed, padded ``y`` (diagonal ``k`` reads the
  contiguous window starting at ``Lx + 1 + Ly - k``);
* borders (column ``j = 0`` at ``i == k``, row ``i = 0``) are injected per
  step, cells outside the valid band are set to ``BIG``, and every DP sum
  is clamped to ``BIG``;
* ragged rows: each row carries ``(len_x, len_y)`` and its answer is read off
  diagonal ``len_x + len_y``;
* fused ε-pruning: a row is certified ``> eps`` when ``min(new, d1)`` over the
  whole padded diagonal exceeds ``eps`` on some step before its answer
  diagonal (every monotone path touches one of any two consecutive
  diagonals).  ``eps = +inf`` rows opt out.

:func:`wavefront` is the entry point: CPU tensors run :func:`wavefront_torch`
(the plain version, the counterpart of ``wavefront_scan``), CUDA tensors
launch the kernel in ``csrc/wavefront.cu`` through :func:`wavefront_cuda`
or raise.  There is no fall back from the card to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

BIG = 3.4e37

#: mode ids of ``csrc/wavefront.cu``
MODE_IDS = {"dtw": 0, "erp": 1, "dfd": 2, "lev": 3}

#: kernel launches by :func:`wavefront_cuda` (one per successful launch)
LAUNCHES = 0

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def wavefront(x_pad, y_rev_pad, gap_x, gap_y_rev, border_col, border_row,
              lens, eps, *, mode: str, Lx: int, Ly: int) -> Out:
    """``(dist, hit, pruned)`` over the padded layout, on the operands'
    device: the plain version for CPU tensors, the CUDA kernel otherwise."""
    if x_pad.device.type == "cpu":
        return wavefront_torch(x_pad, y_rev_pad, gap_x, gap_y_rev,
                               border_col, border_row, lens, eps,
                               mode=mode, Lx=Lx, Ly=Ly)
    return wavefront_cuda(x_pad, y_rev_pad, gap_x, gap_y_rev, border_col,
                          border_row, lens, eps, mode=mode, Lx=Lx, Ly=Ly)


def _shift_right(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.full_like(v[:, :1], BIG), v[:, :-1]], dim=1)


def wavefront_torch(x_pad, y_rev_pad, gap_x, gap_y_rev, border_col,
                    border_row, lens, eps, *, mode: str, Lx: int,
                    Ly: int) -> Out:
    """The plain torch version: the per-diagonal loop of the reference's
    ``_make_step`` in f32 torch ops, vectorised over rows and cells.

    Same operands as the kernel (``lens`` ``(B, 2)`` int, ``eps`` ``(B,)``);
    runs on any device.  Returns ``dist`` (``BIG`` where the row misses),
    ``hit`` and ``pruned`` as ``(B,)`` tensors."""
    B, W, d = x_pad.shape
    dev = x_pad.device
    ii = torch.arange(W, device=dev)
    lx = lens[:, 0:1].to(torch.int64)
    target = lx + lens[:, 1:2].to(torch.int64)
    eps = eps.reshape(B, 1)

    d1 = torch.full((B, W), BIG, device=dev)
    d1[:, 0] = border_col[:, 0]
    d2 = torch.full((B, W), BIG, device=dev)
    res = torch.where(target == 0, d1[:, 0:1], BIG)
    alive = torch.ones((B, 1), dtype=torch.bool, device=dev)
    for k in range(1, Lx + Ly + 1):
        s = Lx + 1 + Ly - k  # start of diagonal k's window in reversed y
        ysl = y_rev_pad[:, s:s + W]
        if mode == "lev":
            acc = (x_pad[..., 0] - ysl[..., 0]).abs()
            for t in range(1, d):
                acc = acc + (x_pad[..., t] - ysl[..., t]).abs()
            c = (acc > 0).to(torch.float32)
        else:
            diff = x_pad[..., 0] - ysl[..., 0]
            acc = diff * diff
            for t in range(1, d):
                diff = x_pad[..., t] - ysl[..., t]
                acc = acc + diff * diff
            c = torch.clamp_max(torch.sqrt(torch.clamp_min(acc, 0.0)), BIG)
        dd = _shift_right(d2)
        du = _shift_right(d1)
        dl = d1
        if mode == "dtw":
            new = c + torch.minimum(dd, torch.minimum(du, dl))
        elif mode == "dfd":
            new = torch.maximum(c, torch.minimum(dd, torch.minimum(du, dl)))
        elif mode == "lev":
            new = torch.minimum(dd + c, torch.minimum(du + 1.0, dl + 1.0))
        else:  # erp
            gy = gap_y_rev[:, s:s + W]
            new = torch.minimum(dd + c,
                                torch.minimum(du + gap_x, dl + gy))
        # clamp: sums of quasi-infinities must stay quasi-infinite
        new = torch.clamp_max(new, BIG)
        if k <= Lx:  # border column j = 0 lives at position i = k
            new[:, k] = border_col[:, k]
        new[:, 0] = border_row[:, k] if k <= Ly else BIG  # border row i = 0
        new[:, (ii > k) | (ii < k - Ly)] = BIG  # outside the valid band
        res = torch.where(target == k, new.gather(1, lx), res)
        rowmin = torch.minimum(new, d1).amin(dim=1, keepdim=True)
        alive = alive & ((rowmin <= eps) | (k > target))
        d2, d1 = d1, new
    hit = res <= eps
    dist = torch.where(hit, res, BIG)
    return dist[:, 0], hit[:, 0], ~alive[:, 0]


def _library() -> ctypes.CDLL:
    lib = build.load("wavefront")
    fn = lib.wavefront_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.wavefront_error_string.restype = ctypes.c_char_p
        lib.wavefront_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def wavefront_cuda(x_pad, y_rev_pad, gap_x, gap_y_rev, border_col,
                   border_row, lens, eps, *, mode: str, Lx: int,
                   Ly: int) -> Out:
    """Launch the CUDA kernel on the current stream (asynchronous).

    Checks device, dtype, shape and contiguity of every operand and raises
    on anything the kernel does not take; raises if the launch is refused.
    The library is built from ``csrc/wavefront.cu`` on first use."""
    global LAUNCHES
    if mode not in MODE_IDS:
        raise ValueError(f"unknown wavefront mode {mode!r}")
    dev = x_pad.device
    if dev.type != "cuda":
        raise ValueError(f"wavefront_cuda needs CUDA tensors; got {dev}")
    if x_pad.ndim != 3:
        raise ValueError(f"x_pad must be (B, Lx+1, d); got {x_pad.shape}")
    B, W, d = x_pad.shape
    if W != Lx + 1 or Lx < 1 or Ly < 1 or B < 1:
        raise ValueError(f"bad dispatch shape B={B} W={W} Lx={Lx} Ly={Ly}")
    Ypad = 2 * Lx + Ly + 1
    f32 = torch.float32
    _check("x_pad", x_pad, (B, W, d), f32, dev)
    _check("y_rev_pad", y_rev_pad, (B, Ypad, d), f32, dev)
    _check("gap_x", gap_x, (B, W), f32, dev)
    _check("gap_y_rev", gap_y_rev, (B, Ypad), f32, dev)
    _check("border_col", border_col, (B, W), f32, dev)
    _check("border_row", border_row, (B, Ly + 1), f32, dev)
    _check("lens", lens, (B, 2), torch.int32, dev)
    _check("eps", eps, (B,), f32, dev)
    dist = torch.empty(B, dtype=f32, device=dev)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    pruned = torch.empty(B, dtype=torch.bool, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wavefront_launch(
        MODE_IDS[mode], x_pad.data_ptr(), y_rev_pad.data_ptr(),
        gap_x.data_ptr(), gap_y_rev.data_ptr(), border_col.data_ptr(),
        border_row.data_ptr(), lens.data_ptr(), eps.data_ptr(),
        dist.data_ptr(), hit.data_ptr(), pruned.data_ptr(), B, Lx, Ly, d,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    if rc != 0:
        msg = lib.wavefront_error_string(rc).decode()
        raise RuntimeError(
            f"wavefront kernel launch failed ({rc}: {msg}) for mode={mode} "
            f"B={B} Lx={Lx} Ly={Ly} d={d}")
    LAUNCHES += 1
    return dist, hit, pruned
