"""Frozen copies of the port's data generators.

Copied verbatim so that a later change to the program cannot move the
benchmark's inputs; ``perfbench/tests/test_bench_frozen.py`` holds each to its
original seed for seed while the original exists.

* :func:`proteins`, :func:`trajectories` -- ``src/repro_torch/data/synthetic.py:17``
  and ``:59``;
* :func:`mutate` -- ``chip_smoke.py:1133`` (its ``import numpy`` hoisted).
"""

from __future__ import annotations

import numpy as np


def proteins(n_windows: int, l: int = 20, alphabet: int = 20,
             n_motifs: int = 64, mutation: float = 0.15, seed: int = 0
             ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    motifs = rng.integers(0, alphabet, size=(n_motifs, l))
    data = motifs[rng.integers(0, n_motifs, n_windows)]
    mut = rng.random((n_windows, l)) < mutation
    return np.where(mut, rng.integers(0, alphabet, size=(n_windows, l)),
                    data).astype(np.int32)


def trajectories(n_windows: int, l: int = 20, seed: int = 0) -> np.ndarray:
    """2-D parking-lot-style trajectories: smooth heading random walks."""
    rng = np.random.default_rng(seed)
    heading = np.cumsum(rng.normal(scale=0.3, size=(n_windows, l)), axis=1)
    speed = 0.5 + 0.2 * rng.random((n_windows, 1))
    dx = np.cos(heading) * speed
    dy = np.sin(heading) * speed
    xy = np.stack([np.cumsum(dx, 1), np.cumsum(dy, 1)], axis=-1)
    origin = rng.uniform(-10, 10, size=(n_windows, 1, 2))
    return (xy + origin).astype(np.float32)


def mutate(data, n, seed, rate=0.1):
    """Database rows perturbed into near-miss queries (token flips or
    Gaussian noise), as the reference's benchmarks make them."""
    rng = np.random.default_rng(seed)
    qs = data[rng.integers(0, len(data), n)].copy()
    if data.dtype.kind in "iu":
        flips = rng.random(qs.shape) < rate
        qs[flips] = rng.integers(0, int(data.max()) + 1, flips.sum())
    else:
        qs += rng.normal(scale=rate * np.std(data),
                         size=qs.shape).astype(qs.dtype)
    return qs

