"""The one-shot device query's ring filter: the hand-written CUDA kernel and
its plain torch version.

A flattened net's query (``core/distributed.py``) gets one distance per
query and pivot, ``dp (Q, P)``, from the wavefront kernel.  Every (query,
member) pair then gets the reference's verdict from the triangle
inequality: accept the pivot's whole list (``dp + pradius <= eps``), prune
it (``dp - pradius > eps``), accept the member (``dp + mdist <= eps``), or
keep it for an exact evaluation (``|dp - mdist| <= eps < dp + mdist``).
Free accepts go straight into the ``(Q, N)`` hit mask; survivors are
compacted, in the order ``torch.nonzero`` gives over ``(q, pivot, slot)``,
into rows the wavefront kernel takes.

The filter visits the real (pivot, member) pairs only, ``Q * Nv`` slots:
the flattened net holds its member lists as those pairs in CSR order
(``FlatNet``'s ``mem_pivot``, ``mem_id``, ``mem_dist``, pivot-major, each
list in its stored order) and uploads them once per version
(``FlatNet.device_arrays``).  It runs in two calls, so
the caller can read the survivor count (its one blocking read) in between:

* :func:`ring_filter` (pass 1): the verdicts, free hits into the mask, and
  the survivor count ``n_need`` as a ``()`` tensor on the operands' device;
* :func:`survivor_rows` (pass 2): each survivor's query ``q_of``, window
  ``w_of`` (int64), query length (int32) and operand rows ``qs[q_of]``,
  ``data[w_of]``, in buffers of exactly ``n_need`` rows.

CPU tensors run the plain versions (:func:`ring_filter_torch`,
:func:`survivor_rows_torch`), CUDA tensors launch ``csrc/ring_filter.cu``
or raise; there is no fall back from the card to the plain version.  Both
compare in f32 with ``eps`` rounded to f32, as torch's comparison of an f32
tensor with a Python float rounds it, and add with one rounding each.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wavefront import _check

#: filters launched by :func:`ring_filter_cuda`, one per filter (its pass
#: 1 and the scan), counted under :data:`_LAUNCH_LOCK`
LAUNCHES = 0
#: pass 2s launched by :func:`survivor_rows_cuda` (one per filter with a
#: survivor), counted under :data:`_LAUNCH_LOCK`
ROW_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


@dataclasses.dataclass
class Verdicts:
    """What pass 1 leaves for pass 2: the ring's operands, ``n_need`` (a
    ``()`` int64 tensor on their device, not read yet) and the order of the
    survivors (the plain version's slot indices, the kernel's per-block
    first rows)."""
    dp: torch.Tensor
    pradius: torch.Tensor
    pivot: torch.Tensor
    ids: torch.Tensor
    mdist: torch.Tensor
    eps: float
    n_need: torch.Tensor
    order: torch.Tensor


class Rows(NamedTuple):
    """The survivors, one row each, in slot order."""
    q_of: torch.Tensor      # (n,) int64 query
    w_of: torch.Tensor      # (n,) int64 window
    q_len: torch.Tensor     # (n,) int32 the query's length
    xs: torch.Tensor        # (n, Lq[, d]) qs[q_of]
    ys: torch.Tensor        # (n, L[, d]) data[w_of]


def ring_filter(dp, pradius, pivot, ids, mdist, eps: float,
                hits) -> Verdicts:
    """Pass 1 on the operands' device: the plain version for CPU tensors,
    the CUDA kernel otherwise.  ``dp`` ``(Q, P)`` f32, ``pradius`` ``(P,)``
    f32, ``pivot``/``ids`` ``(Nv,)`` int32, ``mdist`` ``(Nv,)`` f32;
    ``hits`` the ``(Q, N)`` bool mask the free accepts are set in."""
    if dp.device.type == "cpu":
        return ring_filter_torch(dp, pradius, pivot, ids, mdist, eps, hits)
    return ring_filter_cuda(dp, pradius, pivot, ids, mdist, eps, hits)


def survivor_rows(v: Verdicts, n_need: int, qs, q_lens, data) -> Rows:
    """Pass 2: the ``n_need`` survivors' rows (``n_need`` is ``v.n_need``
    read by the caller).  ``qs`` ``(Q, Lq[, d])``, ``q_lens`` ``(Q,)``
    int32, ``data`` ``(N, L[, d])``, each of any dtype, on ``v``'s
    device."""
    if n_need == 0:
        z = torch.zeros(0, dtype=torch.int64, device=qs.device)
        return Rows(z, z, z.to(torch.int32), qs[:0], data[:0])
    if qs.device.type == "cpu":
        return survivor_rows_torch(v, n_need, qs, q_lens, data)
    return survivor_rows_cuda(v, n_need, qs, q_lens, data)


def _ring(dp, pradius, pivot, mdist, eps):
    """The plain verdicts over ``(Q, Nv)``: ``(free, need)`` masks."""
    pv = pivot.to(torch.int64)
    d = dp[:, pv]
    pr = pradius[pv]
    acc_all = d + pr <= eps                    # accept the whole list
    live = ~(acc_all | (d - pr > eps))         # neither verdict: undecided
    hi = d + mdist
    lo = (d - mdist).abs()
    free = acc_all | (live & (hi <= eps))
    need = live & (lo <= eps) & (hi > eps)
    return free, need


def ring_filter_torch(dp, pradius, pivot, ids, mdist, eps: float,
                      hits) -> Verdicts:
    """The plain pass 1 in torch ops over the ``(Q, Nv)`` slots; runs on
    any device."""
    free, need = _ring(dp, pradius, pivot, mdist, eps)
    qq, jj = free.nonzero(as_tuple=True)
    hits[qq, ids[jj].to(torch.int64)] = True
    sel = need.reshape(-1).nonzero().squeeze(1)
    return Verdicts(dp, pradius, pivot, ids, mdist, eps,
                    torch.tensor(sel.numel(), device=dp.device), sel)


def survivor_rows_torch(v: Verdicts, n_need: int, qs, q_lens,
                        data) -> Rows:
    """The plain pass 2: gathers at the slots pass 1 selected."""
    nv = v.ids.numel()
    q_of = v.order // nv
    w_of = v.ids[v.order % nv].to(torch.int64)
    return Rows(q_of, w_of, q_lens[q_of].to(torch.int32), qs[q_of],
                data[w_of])


def _library() -> ctypes.CDLL:
    lib = build.load("ring_filter")
    if lib.ring_filter_verdicts.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        ring = [ptr] * 5 + [i64, i64, ctypes.c_int, ctypes.c_float]
        lib.ring_filter_tile.restype = ctypes.c_int
        lib.ring_filter_tile.argtypes = []
        lib.ring_filter_verdicts.restype = ctypes.c_int
        lib.ring_filter_verdicts.argtypes = ring + [
            ptr, i64, ptr, ptr, ctypes.c_int, ptr]
        lib.ring_filter_rows.restype = ctypes.c_int
        lib.ring_filter_rows.argtypes = ring + [
            ptr, ptr, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, ptr,
            ctypes.c_int, ptr]
        lib.ring_filter_error_string.restype = ctypes.c_char_p
        lib.ring_filter_error_string.argtypes = [ctypes.c_int]
    return lib


def _ring_args(v: Verdicts):
    Q, P = v.dp.shape
    return (v.dp.data_ptr(), v.pradius.data_ptr(), v.pivot.data_ptr(),
            v.ids.data_ptr(), v.mdist.data_ptr(), v.ids.numel(), Q, P,
            float(v.eps))


def _raise(lib, rc: int, what: str, v: Verdicts) -> None:
    if rc != 0:
        msg = lib.ring_filter_error_string(rc).decode()
        raise RuntimeError(
            f"ring filter {what} launch failed ({rc}: {msg}) for "
            f"Q={v.dp.shape[0]} P={v.dp.shape[1]} Nv={v.ids.numel()}")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def ring_filter_cuda(dp, pradius, pivot, ids, mdist, eps: float,
                     hits) -> Verdicts:
    """Launch pass 1 and its scan on the current stream (asynchronous).
    Checks device, dtype, shape and contiguity of every operand and raises
    on anything the kernel does not take; raises if a launch is refused.
    The library is built from ``csrc/ring_filter.cu`` on first use."""
    global LAUNCHES
    dev = dp.device
    if dev.type != "cuda":
        raise ValueError(f"ring_filter_cuda needs CUDA tensors; got {dev}")
    if dp.ndim != 2 or ids.ndim != 1 or hits.ndim != 2:
        raise ValueError(f"dp {tuple(dp.shape)}, ids {tuple(ids.shape)} and "
                         f"hits {tuple(hits.shape)} must be (Q, P), (Nv,) "
                         "and (Q, N)")
    (Q, P), nv = dp.shape, ids.numel()
    f32, i32 = torch.float32, torch.int32
    for name, t, shape, dtype in (
            ("dp", dp, (Q, P), f32), ("pradius", pradius, (P,), f32),
            ("pivot", pivot, (nv,), i32), ("ids", ids, (nv,), i32),
            ("mdist", mdist, (nv,), f32),
            ("hits", hits, (Q, hits.shape[1]), torch.bool)):
        _check(name, t, shape, dtype, dev)
    if Q >= 1 << 31:
        raise ValueError(f"at most 2**31 - 1 queries; got {Q}")
    if Q == 0 or P == 0 or nv == 0:
        order = torch.zeros(1, dtype=torch.int64, device=dev)
        return Verdicts(dp, pradius, pivot, ids, mdist, eps, order[0], order)
    lib = _library()
    tile = lib.ring_filter_tile()
    nblocks = -(-Q * nv // tile)
    count = torch.empty(nblocks, dtype=torch.int32, device=dev)
    offset = torch.empty(nblocks + 1, dtype=torch.int64, device=dev)
    v = Verdicts(dp, pradius, pivot, ids, mdist, eps, offset[nblocks],
                 offset)
    rc = lib.ring_filter_verdicts(
        *_ring_args(v), hits.data_ptr(), hits.shape[1], count.data_ptr(),
        offset.data_ptr(), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, rc, "verdicts", v)
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return v


def survivor_rows_cuda(v: Verdicts, n_need: int, qs, q_lens,
                       data) -> Rows:
    """Launch pass 2 on the current stream (asynchronous): outputs of
    exactly ``n_need`` rows.  ``qs`` and ``data`` rows are copied as raw
    bytes, so any dtype goes through as it is."""
    global ROW_LAUNCHES
    dev, Q = v.dp.device, v.dp.shape[0]
    if qs.ndim < 2 or data.ndim != qs.ndim:
        raise ValueError(f"qs {tuple(qs.shape)} and data "
                         f"{tuple(data.shape)} must be (rows, L[, d])")
    _check("qs", qs, (Q,) + tuple(qs.shape[1:]), qs.dtype, dev)
    _check("data", data, tuple(data.shape), data.dtype, dev)
    _check("q_lens", q_lens, (Q,), torch.int32, dev)
    out = Rows(torch.empty(n_need, dtype=torch.int64, device=dev),
               torch.empty(n_need, dtype=torch.int64, device=dev),
               torch.empty(n_need, dtype=torch.int32, device=dev),
               torch.empty((n_need,) + tuple(qs.shape[1:]), dtype=qs.dtype,
                           device=dev),
               torch.empty((n_need,) + tuple(data.shape[1:]),
                           dtype=data.dtype, device=dev))
    lib = _library()
    rc = lib.ring_filter_rows(
        *_ring_args(v), v.order.data_ptr(), q_lens.data_ptr(),
        qs.data_ptr(), qs[0].numel() * qs.element_size(), data.data_ptr(),
        data[0].numel() * data.element_size(), out.q_of.data_ptr(),
        out.w_of.data_ptr(), out.q_len.data_ptr(), out.xs.data_ptr(),
        out.ys.data_ptr(), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, rc, "rows", v)
    with _LAUNCH_LOCK:
        ROW_LAUNCHES += 1
    return out
