"""Embedding-space subsequence retrieval — the paper's framework applied to
model hidden states.

Hidden-state windows are fixed-length sequences over (R^d, L2); Euclidean is
metric AND consistent (paper §4), so the full stack applies: windows ->
reference net -> range/NN queries.  Because the windows all share one
length, the degenerate-but-legal Euclidean case of the framework applies
(paper §5 notes its alignment rigidity; for same-length embedding windows
that rigidity is exactly what's wanted).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import device as device_mod
from repro_torch.core.segmentation import Window
from repro_torch.models.layers import NOCTX, Ctx


def embed_windows(model, params, cfg, token_seqs: Sequence[np.ndarray],
                  window: int, *, ctx: Ctx = NOCTX,
                  stride: Optional[int] = None, normalize: bool = True,
                  device=None) -> Tuple[np.ndarray, List[Window]]:
    """Run the model, mean-pool hidden states over fixed windows.

    ``model`` is the model module (``models.registry.get``), ``params`` the
    built network (``model.build``), which must live on ``device`` (default:
    the card).  Returns (windows (N, d) float32, metadata).  Window =
    contiguous span of ``window`` tokens of the hidden states before the
    final norm; stride defaults to the window (non-overlapping, matching the
    paper's database segmentation).  With ``normalize`` each vector is
    divided by ``max(|v|, 1e-9)``.  Under ``ctx``'s mesh the forward is
    partitioned (``params`` laid out by ``params.distribute``; each
    stacked batch split over the batch's mesh axes where they divide it)
    and the hidden states are gathered whole for the pooling.
    """
    stride = stride or window
    dev = device_mod.resolve(device)
    at = next(params.parameters()).device
    if at.type != dev.type or dev.index not in (None, at.index):
        raise ValueError(f"the model's parameters are on {at}; embed_windows "
                         f"was asked to run on {dev}")
    seqs = [np.asarray(t) for t in token_seqs]
    # one stacked forward per token length: sequences sharing a shape ride a
    # single forward instead of one call each
    by_len: dict = {}
    for sid, toks in enumerate(seqs):
        by_len.setdefault(toks.shape[0], []).append(sid)
    pooled: dict = {}
    for S, sids in by_len.items():
        if S < window:  # too short for one window
            pooled.update((sid, ()) for sid in sids)
            continue
        tokens = torch.as_tensor(np.stack([seqs[i] for i in sids])).to(at)
        with torch.no_grad():  # a trainer's network records no graph here
            hs = model.forward(params, {"tokens": tokens}, cfg, ctx,
                               return_hidden=True)
        if isinstance(hs, DTensor):
            hs = hs.full_tensor()
        hs = hs.to(torch.float32)
        # (B, S, d) -> (B, n_windows, d): means over each window's positions
        w = hs.unfold(1, window, stride).mean(dim=-1)
        w = w.cpu().numpy()
        for row, sid in enumerate(sids):
            pooled[sid] = w[row]
    feats, meta = [], []
    for sid in range(len(seqs)):
        for n, vec in enumerate(pooled[sid]):
            feats.append(vec)
            meta.append(Window(seq_id=sid, start=n * stride, length=window))
    out = np.stack(feats)
    if normalize:
        out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)
    return out, meta


class EmbeddingRetriever:
    """Reference net over pooled hidden-state windows (Euclidean).

    Deprecated as a *direct* public entry point since v0.1 — a thin shim
    over the facade's ``index='embedding'`` kind::

        repro_torch.retrieval.Retriever.build(
            RetrievalConfig("euclidean", index="embedding",
                            eps_prime=..., num_max=5,
                            tight_bounds=True), vectors)

    The facade delegates here, so behavior and counts are identical; this
    constructor shim will be removed in v0.2.
    """

    def __init__(self, vectors: np.ndarray, meta: List[Window], *,
                 eps_prime: float = 0.05, num_max: Optional[int] = 5,
                 tight_bounds: bool = True, device=None):
        from repro_torch.core import _deprecation
        from repro_torch.retrieval import RetrievalConfig, Retriever
        _deprecation.warn_legacy("EmbeddingRetriever")
        self.meta = meta
        # each vector is a length-1 sequence of d-dim elements so the
        # registry distance applies (the facade's "embedding" data prep)
        self.retriever = Retriever.build(
            RetrievalConfig("euclidean", index="embedding",
                            eps_prime=eps_prime, num_max=num_max,
                            tight_bounds=tight_bounds,
                            device=str(device_mod.resolve(device))),
            np.asarray(vectors))
        self.net = self.retriever.index
        self.counter = self.net.counter

    def query(self, vec: np.ndarray, eps: float) -> List[Tuple[Window, int]]:
        hits = self.retriever.query(vec).range(eps)
        return [(self.meta[i], i) for i in hits]

    def nearest(self, vec: np.ndarray, eps_max: float = 2.0,
                tol: float = 1e-3):
        rs = self.retriever.query(vec).nearest(eps_max, tol=tol)
        if not rs:
            return None
        return self.meta[rs.first], rs.distances[0]
