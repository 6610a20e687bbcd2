"""Synthetic corpora with matched statistics to the paper's datasets (§8).

The container is offline, so: PROTEINS -> alphabet-20 strings with planted
motifs (Levenshtein); SONGS -> integer pitch walks in [0, 11] (DFD's skewed
distance distribution emerges naturally); TRAJ -> 2-D random-walk
trajectories.  Window size l = 20 follows the paper.  Also provides token
corpora for LM training examples.
"""

from __future__ import annotations

from typing import List

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


def protein_sequences(n_seqs: int, length: int = 400, alphabet: int = 20,
                      n_motifs: int = 64, seed: int = 0) -> List[np.ndarray]:
    """Full sequences (for end-to-end subsequence matching) built by
    concatenating mutated motifs with random linkers."""
    rng = np.random.default_rng(seed)
    motifs = rng.integers(0, alphabet, size=(n_motifs, 20))
    seqs = []
    for _ in range(n_seqs):
        parts = []
        total = 0
        while total < length:
            if rng.random() < 0.7:
                m = motifs[rng.integers(0, n_motifs)].copy()
                mut = rng.random(len(m)) < 0.1
                m[mut] = rng.integers(0, alphabet, mut.sum())
                parts.append(m)
            else:
                parts.append(rng.integers(0, alphabet, size=(20,)))
            total += 20
        seqs.append(np.concatenate(parts)[:length].astype(np.int32))
    return seqs


def songs(n_windows: int, l: int = 20, seed: int = 0) -> np.ndarray:
    """Pitch sequences in [0, 11] — random walks with wraparound."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-2, 3, size=(n_windows, l))
    start = rng.integers(0, 12, size=(n_windows, 1))
    return ((start + np.cumsum(steps, axis=1)) % 12).astype(np.float32)


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


def token_corpus(n_docs: int, doc_len: int, vocab: int, seed: int = 0,
                 dup_frac: float = 0.0) -> np.ndarray:
    """LM training corpus; optionally plants near-duplicate documents (for
    the retrieval-based dedup example)."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, vocab, size=(n_docs, doc_len), dtype=np.int32)
    n_dup = int(dup_frac * n_docs)
    for i in range(n_dup):
        src = rng.integers(0, n_docs)
        dst = rng.integers(0, n_docs)
        if src != dst:
            docs[dst] = docs[src]
            flips = rng.random(doc_len) < 0.02
            docs[dst, flips] = rng.integers(0, vocab, flips.sum())
    return docs


DATASETS = {
    "proteins": (proteins, "levenshtein"),
    "songs": (songs, None),          # used with dfd / erp
    "traj": (trajectories, None),    # used with dfd / erp
}
