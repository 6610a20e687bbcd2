"""The consistency property (paper Def. 1) — machine-checkable form.

``delta`` is *consistent* iff for all sequences Q, X and every contiguous
subsequence SX of X there exists a contiguous subsequence SQ of Q with
``delta(SQ, SX) <= delta(Q, X)``.

The paper proves consistency analytically for Euclidean, Hamming, DTW, ERP,
DFD and Levenshtein (§4).  This module provides the brute-force verifier the
property tests use to re-derive that claim empirically, plus helpers shared
with the segmentation lemmas.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.distances.base import Distance


def all_subsequences(n: int, min_len: int = 1) -> List[Tuple[int, int]]:
    """All (start, length) pairs of contiguous subsequences of a length-n seq."""
    return [(a, ln) for ln in range(min_len, n + 1) for a in range(n - ln + 1)]


def _pad_stack(seqs, L, string):
    if string:
        out = np.zeros((len(seqs), L), np.int32)
    else:
        d = seqs[0].shape[-1] if seqs[0].ndim == 2 else 1
        out = np.zeros((len(seqs), L, d), np.float32)
    lens = np.zeros((len(seqs),), np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s)
        if not string and s.ndim == 1:
            s = s[:, None]
        out[i, : len(s)] = s
        lens[i] = len(s)
    return out, lens


def check_consistency(dist: Distance, Q, X, atol: float = 1e-4,
                      device=None) -> bool:
    """Brute-force Def. 1 check: every SX has an SQ with d(SQ,SX) <= d(Q,X).

    Exponential in nothing but quadratic in |Q|,|X| pairs of subsequences; use
    short sequences (<= ~10) in tests.  Distances are evaluated on
    ``device`` (default: the card).
    """
    Q, X = np.asarray(Q), np.asarray(X)
    dQX = float(dist.pair(_fix(Q, dist), _fix(X, dist), device=device))
    L = max(len(Q), len(X))
    sx = [(X[a : a + ln]) for a, ln in all_subsequences(len(X))]
    sq = [(Q[a : a + ln]) for a, ln in all_subsequences(len(Q))]
    if dist.variable_length is False:
        # Equal-length distances: SQ must have the same length as SX.
        for xs_sub in sx:
            cand = [q for q in sq if len(q) == len(xs_sub)]
            best = min(float(dist.pair(_fix(q, dist), _fix(xs_sub, dist),
                                       device=device)) for q in cand)
            if best > dQX + atol:
                return False
        return True
    xs_pad, xs_len = _pad_stack(sx, L, dist.string)
    qs_pad, qs_len = _pad_stack(sq, L, dist.string)
    mat = dist.matrix(qs_pad, xs_pad, qs_len, xs_len,
                      device=device).cpu().numpy()
    best_per_sx = mat.min(axis=0)
    return bool(np.all(best_per_sx <= dQX + atol))


def _fix(s, dist):
    s = np.asarray(s)
    if not dist.string and s.ndim == 1:
        s = s[:, None]
    return s
