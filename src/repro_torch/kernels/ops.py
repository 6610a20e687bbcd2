"""Public entry points of the hand-written kernels.

``wavefront`` runs a batched alignment distance through the kernel
registry (ragged lengths, dtypes and fused ε live there; the kernel takes
the trimmed rows as they are, and only its plain version builds the
reference's padded layout);
``pairwise_l2`` computes an all-pairs Euclidean matrix.  Both run on the
card by default: the CUDA kernels there, their plain torch versions for
``device="cpu"``.  The reference's TPU knobs (``block_b``, ``interpret``,
``exec``, ``tile``, ``bm``, ``bn``) have no counterpart: each kernel
chooses its own tile and guards its own edges, so nothing is padded here.
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import pairwise_l2 as _pl2
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry

MODES = _ref.MODES


def wavefront(xs, ys, mode: str, *, lens_x=None, lens_y=None, eps=None,
              device=None):
    """Batched alignment distance through the kernel registry.

    ``xs``/``ys``: ``(B, Lx)`` / ``(B, Ly)`` int tokens for ``mode='lev'``,
    else ``(B, Lx[, d])`` / ``(B, Ly[, d])`` float series (numpy arrays or
    tensors); ``lens_x``/``lens_y`` optional per-row lengths (ragged
    batches); ``eps`` an optional fused-ε threshold (scalar or per-row).
    Returns ``(B,)`` float32 distances, or the full
    :class:`~repro_torch.kernels.registry.KernelOut` when ``eps`` is given.
    """
    if mode not in MODES:
        raise ValueError(f"unknown wavefront mode {mode!r}")
    # lint: allow[acct-raw-kernel-call] -- compatibility wrapper: registry.STATS counts its calls; callers (benchmarks, kernel tests) do their own accounting
    out = registry.spec_for_mode(mode).batch(xs, ys, lens_x, lens_y,
                                             eps=eps, device=device)
    return out if eps is not None else out.dist


def wavefront_ref(xs, ys, mode: str, *, device=None):
    """Oracle: the generic wavefront engine (see ``kernels/ref.py``)."""
    dev = device_mod.of(xs, device)
    return _ref.wavefront_ref(device_mod.as_tensor(xs, dev),
                              device_mod.as_tensor(ys, dev), mode)


def _matrix_operands(x, y, device):
    dev = device_mod.of(x, device)
    return (device_mod.as_tensor(x, dev, torch.float32).contiguous(),
            device_mod.as_tensor(y, dev, torch.float32).contiguous())


def pairwise_l2(x, y, *, device=None) -> torch.Tensor:
    """``(M, d) x (N, d) -> (M, N)`` Euclidean distances: the CUDA kernel
    on a CUDA device (default: the device of ``x`` if it is a tensor, else
    the card), its plain version on the CPU.

    This layer only picks the device and turns numpy arrays or other
    dtypes into contiguous f32 tensors there; the one branch between the
    kernel and its plain version is :func:`pairwise_l2.pairwise_l2`, which
    takes tensors as they are (as ``kernels/wavefront.py`` does for the
    wavefront)."""
    return _pl2.pairwise_l2(*_matrix_operands(x, y, device))


def pairwise_l2_ref(x, y, *, device=None) -> torch.Tensor:
    """Oracle: float64 direct differences (see ``kernels/ref.py``)."""
    return _ref.pairwise_l2_ref(*_matrix_operands(x, y, device))
