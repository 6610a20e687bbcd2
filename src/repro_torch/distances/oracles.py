"""Slow, obviously-correct numpy oracles for every registered distance.

Used by unit/property tests and by ``kernels/ref.py`` sanity checks.  These
are straight transcriptions of the textbook row-major DPs.
"""

from __future__ import annotations

import numpy as np

INF = float("inf")


def _elem(a, b):
    a, b = np.atleast_1d(np.asarray(a, np.float64)), np.atleast_1d(np.asarray(b, np.float64))
    return float(np.sqrt(np.sum((a - b) ** 2)))


def euclidean_oracle(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    assert x.shape[0] == y.shape[0]
    return float(np.sqrt(np.sum((x - y) ** 2)))


def hamming_oracle(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.shape[0] == y.shape[0]
    return float(np.sum(x != y))


def dtw_oracle(x, y):
    n, m = len(x), len(y)
    D = np.full((n + 1, m + 1), INF)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c = _elem(x[i - 1], y[j - 1])
            D[i, j] = c + min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[n, m])


def erp_oracle(x, y, g=0.0):
    n, m = len(x), len(y)
    D = np.zeros((n + 1, m + 1))
    for i in range(1, n + 1):
        D[i, 0] = D[i - 1, 0] + _elem(x[i - 1], g)
    for j in range(1, m + 1):
        D[0, j] = D[0, j - 1] + _elem(y[j - 1], g)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            D[i, j] = min(
                D[i - 1, j - 1] + _elem(x[i - 1], y[j - 1]),
                D[i - 1, j] + _elem(x[i - 1], g),
                D[i, j - 1] + _elem(y[j - 1], g),
            )
    return float(D[n, m])


def frechet_oracle(x, y):
    n, m = len(x), len(y)
    D = np.full((n + 1, m + 1), INF)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c = _elem(x[i - 1], y[j - 1])
            D[i, j] = max(c, min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1]))
    return float(D[n, m])


def levenshtein_oracle(x, y):
    n, m = len(x), len(y)
    D = np.zeros((n + 1, m + 1))
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c = 0.0 if x[i - 1] == y[j - 1] else 1.0
            D[i, j] = min(D[i - 1, j - 1] + c, D[i - 1, j] + 1, D[i, j - 1] + 1)
    return float(D[n, m])


ORACLES = {
    "euclidean": euclidean_oracle,
    "hamming": hamming_oracle,
    "dtw": dtw_oracle,
    "erp": erp_oracle,
    "frechet": frechet_oracle,
    "levenshtein": levenshtein_oracle,
}
