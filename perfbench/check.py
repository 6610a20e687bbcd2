"""How ``correct`` is decided: every answer compared is held to the plain
reference's hit set over the same windows, computed afresh from the
inputs the benchmark made (the reference takes nothing the program made).

The numbers compared, each against its limit (an exact comparison, so 0):

* ``mismatched_queries`` -- answered queries whose hit set (global window
  ids) differs from the reference's: a missed window within ``eps`` or a
  window beyond it;
* ``unanswered_queries`` -- queries due in the window that failed or never
  completed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

LIMITS = {"mismatched_queries": 0, "unanswered_queries": 0}


def reference_hits(ref, queries: np.ndarray, windows: np.ndarray,
                   eps: float, device, *, control: bool = False,
                   block_pairs: int = 1 << 21) -> List[np.ndarray]:
    """Sorted ids of the windows within ``eps`` of each query, by the
    reference module ``ref`` over every query-window pair, in blocks of
    queries; ``control`` runs ``ref.CONTROL`` instead."""
    spec = ref.CONTROL if control else {"dtype": ref.DTYPE, "strict": False}
    ws = torch.as_tensor(windows, device=device)
    N = ws.shape[0]
    per = max(1, block_pairs // N)
    eps_t = torch.tensor(eps, dtype=torch.float32)
    out: List[np.ndarray] = []
    for q0 in range(0, len(queries), per):
        qb = torch.as_tensor(queries[q0:q0 + per], device=device)
        Q = qb.shape[0]
        x = qb[:, None].expand(Q, N, *qb.shape[1:]).reshape(
            Q * N, *qb.shape[1:])
        y = ws[None].expand(Q, N, *ws.shape[1:]).reshape(
            Q * N, *ws.shape[1:])
        d = ref.pair_distances(x, y, spec["dtype"]).float().cpu()
        hit = d < eps_t if spec["strict"] else d <= eps_t
        hit = hit.reshape(Q, N).numpy()
        out.extend(np.flatnonzero(h) for h in hit)
    return out


def compare(answers: Sequence[Optional[Sequence[int]]],
            expected: Sequence[np.ndarray]) -> dict:
    """The compared numbers of answers (``None``: never answered) against
    the reference's hit sets, plus the hits missed and added."""
    mismatched = unanswered = missed = added = 0
    for got, want in zip(answers, expected):
        if got is None:
            unanswered += 1
            continue
        g, w = set(int(i) for i in got), set(int(i) for i in want)
        if g != w:
            mismatched += 1
            missed += len(w - g)
            added += len(g - w)
    return {"mismatched_queries": mismatched,
            "unanswered_queries": unanswered,
            "missed_hits": missed, "added_hits": added,
            "compared": len(expected),
            "reference_hits": int(sum(len(w) for w in expected))}
