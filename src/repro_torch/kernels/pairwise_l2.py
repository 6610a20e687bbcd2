"""All-pairs Euclidean distance matrix: the hand-written CUDA kernel and its
plain torch version.

The embedding-retrieval path filters M query windows against N database
windows under L2: ``D[i, j] = sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0))``.
This replaces the Pallas TPU kernel ``src/repro/kernels/pairwise_l2.py``
(``_kernel`` under ``pairwise_l2_pallas``); the CUDA source,
``csrc/pairwise_l2.cu``, says how it is laid out on the card: 3xTF32
products on the tensor cores (``wgmma``), operands staged by TMA, within a
derived bound of the f32 plain version.  Unlike the TPU path, nothing is
padded to tile multiples: the kernel guards its edges.

:func:`pairwise_l2` is the entry point: CPU tensors run
:func:`pairwise_l2_torch` (the plain version), CUDA tensors launch the
kernel through :func:`pairwise_l2_cuda` or raise.  There is no fall back
from the card to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches by :func:`pairwise_l2_cuda` (one per successful launch)
LAUNCHES = 0

#: what the launcher chose for the last launch: ``loader`` ``"tma"`` (d a
#: multiple of 4, 16-byte aligned rows) or ``"plain"``, ``tile`` ``"64x80"``
#: or ``"128x128"``
LAST_PLAN: dict = {}


def pairwise_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(M, d) x (N, d) -> (M, N)`` f32 distances on the operands' device:
    the plain version for CPU tensors, the CUDA kernel otherwise."""
    if x.device.type == "cpu":
        return pairwise_l2_torch(x, y)
    return pairwise_l2_cuda(x, y)


def pairwise_l2_torch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain torch version: the norm-and-dot identity of the reference
    kernel in f32 torch ops (one matrix product); runs on any device."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xn = (x * x).sum(dim=1)
    yn = (y * y).sum(dim=1)
    d2 = xn[:, None] + yn[None, :] - 2.0 * (x @ y.T)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _library() -> ctypes.CDLL:
    lib = build.load("pairwise_l2")
    fn = lib.pairwise_l2_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        lib.pairwise_l2_error_string.restype = ctypes.c_char_p
        lib.pairwise_l2_error_string.argtypes = [ctypes.c_int]
    return lib


def pairwise_l2_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (asynchronous).

    ``x`` ``(M, d)`` and ``y`` ``(N, d)`` must be contiguous f32 tensors on
    one CUDA device with ``d >= 1``; anything else raises ``ValueError``, as
    does a refused launch (``RuntimeError``).  An empty ``x`` or ``y`` gives
    an empty matrix without a launch.  The library is built from
    ``csrc/pairwise_l2.cu`` on first use."""
    global LAUNCHES
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"pairwise_l2_cuda needs CUDA tensors; got {dev}")
    if y.device != dev:
        raise ValueError(f"y is on {y.device}, expected {dev}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected "
                             "torch.float32")
        if t.ndim != 2:
            raise ValueError(f"{name} must have shape (rows, d); got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    (M, d), N = x.shape, y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"x and y have widths {d} and {y.shape[1]}; they "
                         "must agree")
    if d < 1:
        raise ValueError("the feature width d must be >= 1")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = ctypes.c_int(0)
    rc = lib.pairwise_l2_launch(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, d,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream, ctypes.byref(plan))
    if rc != 0:
        msg = lib.pairwise_l2_error_string(rc).decode()
        raise RuntimeError(f"pairwise_l2 kernel launch failed ({rc}: {msg}) "
                           f"for M={M} N={N} d={d}")
    LAUNCHES += 1
    LAST_PLAN.update(loader="tma" if plan.value & 1 else "plain",
                     tile="128x128" if plan.value & 2 else "64x80")
    return out
