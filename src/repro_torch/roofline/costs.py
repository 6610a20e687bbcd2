"""Roofline costs on one NVIDIA H100: the card's peaks, the hand-written
kernels' cost models, and flop counts of any torch program.

The reference (``repro/roofline/hlo_costs.py``) reads flops and bytes off
a compiled XLA program.  Here a program is counted as it runs:
:func:`count_flops` runs it under ``torch.utils.flop_counter``'s
``FlopCounterMode``, which counts matrix products (``mm``, ``bmm``,
``addmm``, ``baddbmm``, attention and convolutions, ``2 x`` multiply-adds)
and no elementwise work, as the reference's dot count does.  On ``meta``
tensors the program allocates nothing and the count needs no card
(``launch/dryrun.py``); on ``cuda`` it is the count of what ran.

A partitioned program (a step under a mesh ``Ctx``, ``DTensor``s) is
counted on one rank by :func:`count_collectives`: the matrix-product flops
of the rank's local products and the operand bytes of its collectives, by
kind (the reference's ``hlo_costs`` layout).

The two kernels' costs are models of the work their function needs,
whatever implements it (:func:`wavefront_cost`, :func:`pairwise_l2_cost`,
and :func:`kernel_cost_report` over a kernel's own arguments); a decode
step's least bytes are :func:`decode_step_bytes`.  A bound is the larger of
the bytes over the HBM rate and the operations over the peak of their
type.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
HBM_BYTES = 80 * 2**30


def peak_flops(dtype: torch.dtype) -> float:
    """The card's matrix-product peak for operands of ``dtype``: bf16 and
    f16 on the tensor cores, f32 outside them (the port runs f32 products
    with TF32 off)."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_BF16_FLOPS
    if dtype == torch.float32:
        return PEAK_F32_FLOPS
    raise ValueError(f"no peak for {dtype}")


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


def pairwise_l2_cost(M: int, N: int, d: int) -> Dict:
    """Cost of the f32-accurate all-pairs squared L2 of ``(M, d)`` against
    ``(N, d)``: ``{flops, bytes, bound_ms, bound_by, f32_bound_ms}``.

    Operations: the three TF32 products of the 3xTF32 split, 3 x 2MNd,
    over the tensor-core peak, plus the norms (2(M+N)d, a multiply and an
    add per element) and the epilogue (5MN) over the f32 peak; bytes: x and
    y read once and D written once over HBM rate.  ``f32_bound_ms`` is the
    bound of an f32 kernel, every operation over the f32 peak."""
    t_ops = (6.0 * M * N * d / PEAK_TF32_FLOPS
             + (2.0 * (M + N) * d + 5.0 * M * N) / PEAK_F32_FLOPS) * 1e3
    nbytes = 4.0 * ((M + N) * d + M * N)
    t_bytes = bytes_ms(nbytes)
    f32 = max(t_bytes, (2.0 * M * N * d + 2.0 * (M + N) * d + 5.0 * M * N)
              / PEAK_F32_FLOPS * 1e3)
    by_ops = t_ops >= t_bytes
    return {"flops": 6.0 * M * N * d + 2.0 * (M + N) * d + 5.0 * M * N,
            "bytes": nbytes,
            "bound_ms": t_ops if by_ops else t_bytes,
            "bound_by": "operations" if by_ops else "bytes",
            "f32_bound_ms": f32}


def kernel_cost_report(name: str, *args, **kwargs) -> Dict:
    """The roofline inputs of one call of a hand-written kernel, from the
    arguments its wrapper takes: ``wavefront`` ``(xs, ys, lens, eps,
    mode=)`` (``lens`` ``(B, 2)``), ``pairwise_l2`` ``(x, y)``.  Returns
    the cost model's dict (``ops`` or ``flops``, ``bytes``, ``bound_ms``,
    ``bound_by`` and the earlier or f32 bound) with ``intensity``, the
    operations per byte."""
    if name == "wavefront":
        xs, ys, lens, eps = args
        lens = _np(lens)
        rep = wavefront_cost(kwargs["mode"], xs, ys, lens[:, 0], lens[:, 1],
                             eps)
        work = rep["ops"]
    elif name == "pairwise_l2":
        x, y = args
        rep = pairwise_l2_cost(x.shape[0], y.shape[0], x.shape[1])
        work = rep["flops"]
    else:
        raise KeyError(f"no cost model for kernel {name!r}")
    return {**rep, "intensity": work / rep["bytes"]}


def decode_step_bytes(model, cache_bytes: int) -> Tuple[int, int]:
    """The least bytes one decode step of ``model`` (a network of
    ``repro_torch.models``) must read: every parameter but the token table
    (a step gathers B of its rows) and the cache.  The hybrid's one shared
    block is read once per application (at 134 MB in bf16 it does not stay
    in the 50 MB L2 from one application to the next).  Returns (bytes,
    weight bytes as counted); :func:`bytes_ms` of the first is the step's
    bound."""
    w = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
            if n != "tok.weight")
    cfg = model.cfg
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        shared = sum(p.numel() * p.element_size()
                     for p in model.shared.parameters())
        w += (hybrid.n_applications(cfg) - 1) * shared
    return w + cache_bytes, w


def count_flops(fn, *args, **kwargs):
    """``(flops, fn(*args, **kwargs))``: the matrix-product flops of one
    call, counted by ``FlopCounterMode`` as the call runs (``meta``
    tensors included).  Work inside a backward pass that the call runs
    (``torch.autograd.grad``, recomputation of checkpointed blocks) is
    counted."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    with mode:
        out = fn(*args, **kwargs)
    return mode.get_total_flops(), out


#: collective kinds, the reference's names (``hlo_costs._COLLECTIVES``)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
#: ``c10d_functional`` ops (and their autograd twins) -> kind
_COLLECTIVE_OPS = {
    f"{ns}::{op}": kind
    for ns in ("_c10d_functional", "_c10d_functional_autograd")
    for op, kind in (("all_reduce", "all-reduce"),
                     ("all_reduce_", "all-reduce"),
                     ("all_gather_into_tensor", "all-gather"),
                     ("reduce_scatter_tensor", "reduce-scatter"),
                     ("all_to_all_single", "all-to-all"))}


def count_collectives(fn, *args, trace: Optional[list] = None, **kwargs):
    """``(flops, collectives, fn(*args, **kwargs))`` of one call on this
    rank: the matrix-product flops of the local products it runs
    (``FlopCounterMode``'s formulas, backward passes included) and
    ``collectives``, the operand bytes of its ``c10d_functional``
    collectives per kind with ``total_bytes`` and the number of calls per
    kind under ``counts``.  ``DTensor`` ops are not counted themselves,
    only the local ops and collectives they run, and so is nothing of
    ``DTensor``'s shape propagation (fake tensors).  ``trace``, a list,
    gets ``(kind, operand shape, dtype)`` of each collective in order."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    fake_key = torch._C._TorchDispatchModeKey.FAKE
    coll = {k: 0 for k in COLLECTIVES}
    calls = {k: 0 for k in COLLECTIVES}
    total = [0]

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if torch._C._get_dispatch_mode(fake_key) is not None:
                return out
            name = func._overloadpacket._qualified_op_name
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                t = args[0]
                coll[kind] += t.numel() * t.element_size()
                calls[kind] += 1
                if trace is not None:
                    trace.append((kind, tuple(t.shape), t.dtype))
            elif func._overloadpacket in flop_registry:
                total[0] += flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out)
            return out

    with _Count():
        out = fn(*args, **kwargs)
    return total[0], {**coll, "total_bytes": sum(coll.values()),
                      "counts": calls}, out
