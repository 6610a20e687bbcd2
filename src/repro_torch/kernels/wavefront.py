"""Batched anti-diagonal wavefront alignment DP: the hand-written CUDA kernel
and its plain torch version.

This is the paper's compute hot spot (§5/§7 steps 2 and 4: every index-build
pair and every query segment against every surviving database window goes
through an O(l^2) alignment DP).  It replaces the Pallas TPU kernel
``src/repro/kernels/wavefront.py:wavefront_pallas`` and computes the same
function:

* diagonal ``k = i + j`` of the DP table depends only on diagonals ``k-1``
  and ``k-2``, so the ``Lx + Ly`` steps each update one ``(B, Lx+1)``
  diagonal;
* each cell's cost is computed on the fly from ``x[i-1]`` and ``y[j-1]``;
* borders (column ``j = 0`` at ``i == k``, row ``i = 0``) are injected per
  step, cells outside the valid band are set to ``BIG``, and every DP sum
  is clamped to ``BIG``;
* ragged rows: each row carries ``(len_x, len_y)`` and its answer is read off
  diagonal ``len_x + len_y``;
* fused ε-pruning: a row is certified ``> eps`` when ``min(new, d1)`` over the
  whole dispatch width ``Lx + 1`` (padding cells included) exceeds ``eps``
  on some step up to its answer diagonal (every monotone path touches one of
  any two consecutive diagonals).  ``eps = +inf`` rows opt out.

Operands are the dispatch's rows as they are, unpadded: ``xs`` ``(B, Lx)`` /
``ys`` ``(B, Ly)`` int32 token ids for ``lev`` (:func:`lev_operand`; the
kernel and the plain version compare them as integers, so every id of int32
is exact, where the reference's f32 cast rounds ids of ``2**24`` and above
together), else ``(B, Lx, d)`` / ``(B, Ly, d)`` f32 series;
``lens`` ``(B, 2)`` int32 ``(len_x, len_y)``; ``eps`` ``(B,)`` f32.  Content
past a row's own lengths is the dispatch's padding and enters the
certificate exactly as in the reference.

:func:`wavefront` is the entry point: CPU tensors run :func:`wavefront_torch`
(the plain version, the counterpart of ``wavefront_scan``, which first builds
the reference's padded layout with :func:`padded_layout`), CUDA tensors
launch the kernel in ``csrc/wavefront.cu`` through :func:`wavefront_cuda`
or raise.  The kernel builds borders, gaps and costs on chip and never sees
the padded layout.  There is no fall back from the card to the plain
version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from repro_torch.distances._wavefront import sum_last
from repro_torch.kernels import build

BIG = 3.4e37

#: mode ids of ``csrc/wavefront.cu``
MODE_IDS = {"dtw": 0, "erp": 1, "dfd": 2, "lev": 3}

#: kernel launches by :func:`wavefront_cuda` (one per successful launch;
#: counted under :data:`_LAUNCH_LOCK`, since a serving thread and a
#: resharding thread launch at once)
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: the token ids the Levenshtein mode takes: those of int32
TOKEN_MIN, TOKEN_MAX = -(1 << 31), (1 << 31) - 1


def check_token_ids(a) -> None:
    """Raise ``ValueError`` unless ``a`` (numpy array or tensor) holds
    integer token ids inside int32 (floats must hold whole numbers).  On a
    CUDA tensor of another dtype than int32 this waits for the card."""
    if isinstance(a, torch.Tensor):
        if a.numel() == 0 or a.dtype == torch.int32:
            return
        if a.is_floating_point() and not bool(
                (torch.isfinite(a) & (a == torch.floor(a))).all()):
            raise ValueError("Levenshtein token ids must be whole numbers")
        lo, hi = float(a.min()), float(a.max())
    else:
        a = np.asarray(a)
        if a.size == 0 or a.dtype == np.int32:
            return
        if a.dtype.kind not in "biuf":
            raise ValueError(f"Levenshtein tokens of dtype {a.dtype}")
        if a.dtype.kind == "f" and not np.all(np.isfinite(a)
                                              & (a == np.floor(a))):
            raise ValueError("Levenshtein token ids must be whole numbers")
        lo, hi = a.min(), a.max()
    if lo < TOKEN_MIN or hi > TOKEN_MAX:
        raise ValueError(
            f"Levenshtein token ids must lie in int32 [-2**31, 2**31); got "
            f"[{lo}, {hi}]")


def lev_operand(a, device=None) -> torch.Tensor:
    """Levenshtein tokens (numpy array or tensor of any integer dtype, or
    floats holding whole numbers, taken by value) as the wavefront takes
    them: a contiguous int32 tensor on ``device`` (default: the tensor's
    own).  Raises ``ValueError`` for ids outside int32
    (:func:`check_token_ids`); the check is on the host for numpy input,
    and int32 input passes through unchecked and uncopied."""
    check_token_ids(a)
    if isinstance(a, torch.Tensor):
        t = a.to(device=device or a.device, dtype=torch.int32)
    else:
        t = torch.as_tensor(np.ascontiguousarray(a, np.int32)).to(device)
    return t.contiguous()


def wavefront(xs, ys, lens, eps, *, mode: str) -> Out:
    """``(dist, hit, pruned)`` of each row pair, on the operands' device:
    the plain version for CPU tensors, the CUDA kernel otherwise."""
    if xs.device.type == "cpu":
        return wavefront_torch(xs, ys, lens, eps, mode=mode)
    return wavefront_cuda(xs, ys, lens, eps, mode=mode)


def _cumsum_seq(t: torch.Tensor) -> torch.Tensor:
    """Prefix sums along axis 1, left to right one add at a time — the
    order of numpy's host wavefront on every device (a CUDA scan may
    associate differently)."""
    cols = [t[:, 0]]
    for j in range(1, t.shape[1]):
        cols.append(cols[-1] + t[:, j])
    return torch.stack(cols, dim=1)


def padded_layout(xs, ys, lens, mode: str):
    """The reference's padded wavefront layout (its ``KernelSpec._wavefront``
    prep), the first step of the plain version: x shift-padded so position
    ``i`` holds ``x[i-1]``; y reversed and padded so diagonal ``k`` reads
    window start ``Lx+1+Ly-k``; ERP gap costs zeroed past each row's own
    length; ``BIG``-clamped border cumsums.  Returns ``(x_pad, y_rev_pad,
    gap_x, gap_y_rev, border_col, border_row)`` and ``(Lx, Ly)``; for
    ``lev`` the pads are the int32 ids, zeros as padding."""
    if mode == "lev":
        if xs.dtype != torch.int32 or ys.dtype != torch.int32:
            raise ValueError(f"lev tokens must be int32 ids "
                             f"(lev_operand); got {xs.dtype}/{ys.dtype}")
    else:
        xs, ys = xs.to(torch.float32), ys.to(torch.float32)
    if xs.ndim == 2:
        xs, ys = xs[..., None], ys[..., None]
    B, Lx, d = xs.shape
    Ly = ys.shape[1]
    dev = xs.device
    lx, ly = lens[:, 0].to(torch.int64), lens[:, 1].to(torch.int64)
    Ypad = 2 * Lx + Ly + 1
    x_pad = torch.zeros((B, Lx + 1, d), dtype=xs.dtype, device=dev)
    x_pad[:, 1:] = xs
    y_rev_pad = torch.zeros((B, Ypad, d), dtype=xs.dtype, device=dev)
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
    return (x_pad, y_rev_pad, gap_x, gap_y_rev, border_col,
            border_row), (Lx, Ly)


def _shift_right(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.full_like(v[:, :1], BIG), v[:, :-1]], dim=1)


def wavefront_torch(xs, ys, lens, eps, *, mode: str) -> Out:
    """The plain torch version: :func:`padded_layout`, then the per-diagonal
    loop of the reference's ``_make_step`` in f32 torch ops, vectorised over
    rows and cells.

    Same operands as the kernel (``lev`` tokens int32 only, as
    :func:`lev_operand` gives them); runs on any device.  Returns ``dist`` (``BIG`` where the row misses),
    ``hit`` and ``pruned`` as ``(B,)`` tensors."""
    (x_pad, y_rev_pad, gap_x, gap_y_rev, border_col, border_row), (Lx, Ly) \
        = padded_layout(xs, ys, lens, mode)
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
        if mode == "lev":  # int32 ids, compared as integers
            c = (x_pad[..., 0] != ysl[..., 0]).to(torch.float32)
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
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.wavefront_error_string.restype = ctypes.c_char_p
        lib.wavefront_error_string.argtypes = [ctypes.c_int]
        lib.wavefront_smem_bytes.restype = ctypes.c_int
        lib.wavefront_smem_bytes.argtypes = ([ctypes.c_int] * 4
                                             + [ctypes.POINTER(ctypes.c_int)])
    return lib


def smem_bytes(mode: str, Lx: int, Ly: int, d: int) -> Tuple[int, int]:
    """(dynamic shared memory bytes of one block, rows per block; 0 rows:
    one block per row) that the launcher chooses for a dispatch of widths
    ``Lx``, ``Ly`` and ``d``: the kernel's on-chip fact beside its cost
    model (``roofline/costs.wavefront_cost``).  The library is built from
    ``csrc/wavefront.cu`` on first use."""
    rows = ctypes.c_int(0)
    nbytes = _library().wavefront_smem_bytes(MODE_IDS[mode], Lx, Ly, d,
                                             ctypes.byref(rows))
    return nbytes, rows.value


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


def wavefront_cuda(xs, ys, lens, eps, *, mode: str) -> Out:
    """Launch the CUDA kernel on the current stream (asynchronous).

    ``xs``/``ys`` are ``(B, Lx)``/``(B, Ly)`` int32 token ids for ``lev``
    (:func:`lev_operand`), else
    ``(B, Lx, d)``/``(B, Ly, d)`` f32; ``lens`` ``(B, 2)`` int32; ``eps``
    ``(B,)`` f32.  Checks device, dtype, shape and contiguity of every
    operand and raises on anything the kernel does not take; raises if the
    launch is refused.  The library is built from ``csrc/wavefront.cu`` on
    first use."""
    global LAUNCHES
    if mode not in MODE_IDS:
        raise ValueError(f"unknown wavefront mode {mode!r}")
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"wavefront_cuda needs CUDA tensors; got {dev}")
    if mode == "lev":
        if xs.ndim != 2:
            raise ValueError(f"lev tokens must be (B, Lx); got {xs.shape}")
        (B, Lx), d = xs.shape, 1
        Ly = ys.shape[1] if ys.ndim == 2 else -1
        yshape = (B, Ly)
    else:
        if xs.ndim != 3:
            raise ValueError(f"xs must be (B, Lx, d); got {xs.shape}")
        B, Lx, d = xs.shape
        Ly = ys.shape[1] if ys.ndim == 3 else -1
        yshape = (B, Ly, d)
    if Lx < 1 or Ly < 1 or B < 1 or d < 1:
        raise ValueError(f"bad dispatch shape B={B} Lx={Lx} Ly={Ly} d={d}")
    operand = torch.int32 if mode == "lev" else torch.float32
    _check("xs", xs, tuple(xs.shape), operand, dev)
    _check("ys", ys, yshape, operand, dev)
    _check("lens", lens, (B, 2), torch.int32, dev)
    _check("eps", eps, (B,), torch.float32, dev)
    dist = torch.empty(B, dtype=torch.float32, device=dev)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    pruned = torch.empty(B, dtype=torch.bool, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wavefront_launch(
        MODE_IDS[mode], xs.data_ptr(), ys.data_ptr(), lens.data_ptr(),
        eps.data_ptr(), dist.data_ptr(), hit.data_ptr(), pruned.data_ptr(),
        B, Lx, Ly, d,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    if rc != 0:
        msg = lib.wavefront_error_string(rc).decode()
        raise RuntimeError(
            f"wavefront kernel launch failed ({rc}: {msg}) for mode={mode} "
            f"B={B} Lx={Lx} Ly={Ly} d={d}")
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return dist, hit, pruned
