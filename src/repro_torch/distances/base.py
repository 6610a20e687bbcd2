"""Distance registry: every sequence distance used by the framework.

The paper (§4) classifies distances along two axes that this registry makes
explicit and machine-checkable:

* ``consistent`` — Def. 1: for every subsequence SX of X there is a
  subsequence SQ of Q with delta(SQ, SX) <= delta(Q, X).  Required by the
  segmentation filter (Lemmas 1-3).
* ``metric`` — triangle inequality + symmetry.  Required by the metric
  indexes (reference net, cover tree, MV reference indexing).

DTW is consistent but NOT metric (paper §5), so the registry lets the
matching pipeline accept it while the index constructors reject it.

Sequences are arrays:

* time series: ``(l, d)`` float arrays (d >= 1);
* strings:     ``(l,)`` integer arrays over a finite alphabet.

Batched signatures (the only ones used on the hot path), each taking
numpy arrays or tensors plus an optional ``device`` (default: the device
of a tensor argument, else the card) and returning tensors:

* ``pair(x, y, len_x=None, len_y=None, device=None)``    -> scalar tensor
* ``batch(xs, ys, len_x=None, len_y=None, device=None)`` -> (B,)   paired
* ``matrix(xs, ys, len_x=None, len_y=None, device=None)`` -> (M, N) all pairs

Alignment distances may additionally register a cheap numpy ``lower_bound``
with the ``batch`` signature (``distances/bounds.py``); the frontier engine
uses it to skip exact O(l^2) DPs for candidates whose bound already exceeds
the query radius.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch import device as device_mod

_REGISTRY: Dict[str, "Distance"] = {}


@dataclasses.dataclass(frozen=True)
class Distance:
    """A registered sequence distance."""

    name: str
    #: paired batch: (B,l,d)/(B,l) x2 -> (B,)
    batch: Callable
    #: all-pairs: (M,...),(N,...) -> (M,N)
    matrix: Callable
    metric: bool
    consistent: bool
    #: operates on integer token sequences (strings) rather than R^d series
    string: bool
    #: supports unequal lengths (alignment-based distances)
    variable_length: bool
    doc: str = ""
    #: optional vectorized numpy lower bound, row-wise <= batch(...); used by
    #: the batch engine's LB cascade.  None = no cheap bound available.
    lower_bound: Optional[Callable] = None
    #: optional tier-1 envelope bound (LB_Keogh lineage, O(B*L) elementwise;
    #: ``distances/bounds.py``): same signature plus a ``y_env`` keyword for
    #: precomputed per-candidate envelope statistics.  None = the cascade's
    #: ``"envelope"`` tier falls back to the endpoint tier alone.
    envelope_bound: Optional[Callable] = None

    def pair(self, x, y, len_x=None, len_y=None, device=None):
        dev = device_mod.of(x, device)
        x = device_mod.as_tensor(x, dev)
        y = device_mod.as_tensor(y, dev)
        len_x = x.shape[0] if len_x is None else int(len_x)
        len_y = y.shape[0] if len_y is None else int(len_y)
        L = max(x.shape[0], y.shape[0])
        x = _pad_to(x, L)
        y = _pad_to(y, L)
        lens = torch.tensor([[len_x], [len_y]], device=dev)
        return self.batch(x[None], y[None], lens[0], lens[1])[0]


def _pad_to(x: torch.Tensor, L: int) -> torch.Tensor:
    if x.shape[0] == L:
        return x
    pad = x.new_zeros((L - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad])


def register(dist: Distance) -> Distance:
    if dist.name in _REGISTRY:
        raise ValueError(f"distance {dist.name!r} already registered")
    _REGISTRY[dist.name] = dist
    return dist


def get(name: str) -> Distance:
    # import for registration side effects
    from repro_torch.distances import lp, dtw, erp, frechet, levenshtein  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown distance {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names():
    from repro_torch.distances import lp, dtw, erp, frechet, levenshtein  # noqa: F401

    return sorted(_REGISTRY)


def resolve(dist: Union[str, Distance]) -> Distance:
    """Accept a registry name or a ``Distance`` instance interchangeably.

    Every index / facade constructor funnels its ``dist`` argument through
    here, so callers never have to care which form they hold.  An instance
    that was never registered is returned as-is (third-party distances can
    be used without touching the global registry).
    """
    if isinstance(dist, Distance):
        return dist
    return get(dist)


def require_metric(dist: Union[str, Distance]) -> Distance:
    """Fetch a distance for use inside a metric index (paper §5, §6).

    Raises if the distance does not obey the triangle inequality — e.g. DTW,
    which the paper explicitly excludes from the indexed path.
    """
    d = resolve(dist)
    if not d.metric:
        raise ValueError(
            f"distance {d.name!r} is not a metric; the reference net / cover "
            "tree / MV index require metricity (paper §5). Use the "
            "segmentation filter with a linear scan instead."
        )
    return d


def require_consistent(dist: Union[str, Distance]) -> Distance:
    """Fetch a distance for use with the segmentation filter (Lemmas 1-3)."""
    d = resolve(dist)
    if not d.consistent:
        raise ValueError(
            f"distance {d.name!r} is not consistent; the segmentation filter "
            "requires consistency (paper Def. 1)."
        )
    return d
