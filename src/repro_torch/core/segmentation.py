"""Segmentation (paper §5, §7 steps 1 & 3).

* Database sequences are partitioned into fixed-length, non-overlapping
  windows of length ``l = lambda/2`` (Lemma 2: l <= lambda/2 guarantees every
  similar subsequence of length >= lambda fully contains a window).
* Query sequences yield *sliding* segments of every length in
  ``[l - lambda0, l + lambda0]`` (at most (2*lambda0+1)*|Q| segments).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Window:
    """A database window: sequence ``seq_id``, elements [start, start+length)."""
    seq_id: int
    start: int
    length: int


@dataclasses.dataclass(frozen=True)
class Segment:
    """A query segment: elements [start, start+length) of the query."""
    start: int
    length: int


def window_length(lam: int) -> int:
    """Lemma 2: the fixed window length is lambda // 2 (l <= lambda/2)."""
    if lam < 2:
        raise ValueError("lambda must be >= 2")
    return lam // 2


def partition_windows(seqs: Sequence[np.ndarray], lam: int
                      ) -> Tuple[np.ndarray, List[Window]]:
    """Partition database sequences into fixed windows of length lambda//2.

    Returns (stacked window array (n_win, l[, d]), window metadata).
    Trailing remainders shorter than l are dropped, as in the paper
    (|X|/l windows per sequence).
    """
    l = window_length(lam)
    arrays, meta = [], []
    for sid, x in enumerate(seqs):
        x = np.asarray(x)
        n = len(x) // l
        for w in range(n):
            arrays.append(x[w * l:(w + 1) * l])
            meta.append(Window(seq_id=sid, start=w * l, length=l))
    if not arrays:
        raise ValueError("no windows produced; sequences shorter than lambda/2")
    return np.stack(arrays), meta


def query_segments(Q: np.ndarray, lam: int, lambda0: int
                   ) -> Dict[int, Tuple[np.ndarray, List[Segment]]]:
    """Extract all query segments with lengths in [l-lambda0, l+lambda0].

    Returns {length: (stacked (n, length[, d]) array, segment metadata)} —
    bucketed by length so the batched distance kernels see static shapes.
    """
    Q = np.asarray(Q)
    l = window_length(lam)
    out: Dict[int, Tuple[np.ndarray, List[Segment]]] = {}
    lmin = max(1, l - lambda0)
    lmax = l + lambda0
    for ln in range(lmin, lmax + 1):
        if ln > len(Q):
            continue
        segs = [Segment(start=a, length=ln) for a in range(len(Q) - ln + 1)]
        arr = np.stack([Q[s.start:s.start + ln] for s in segs])
        out[ln] = (arr, segs)
    return out


def subsequence(x: np.ndarray, start: int, length: int) -> np.ndarray:
    return np.asarray(x)[start:start + length]
