"""Deterministic, shardable data pipeline with background prefetch.

* every batch is derived from (seed, step) — restart at step k reproduces
  the exact stream (checkpoint/resume safe, and data-parallel workers can
  slice their shard without coordination);
* a background thread keeps ``prefetch`` batches ready so host input never
  serializes with device compute;
* optional near-duplicate filtering through the paper's retrieval stack
  (windows of token ids indexed in a reference net; documents whose windows
  match an already-seen document within eps are dropped) — subsequence
  retrieval as a data-quality substrate.  Its distance evaluations run on
  the counter's ``kernel`` backend: on the card every dispatch is one
  launch of the wavefront kernel.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class TokenBatcher:
    """(seed, step) -> {'tokens': (B, S), 'labels': (B, S)} int32."""

    def __init__(self, corpus: np.ndarray, batch: int, seq: int,
                 seed: int = 0, shard: int = 0, n_shards: int = 1):
        assert corpus.ndim == 2
        self.corpus = corpus
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.shard = shard
        self.n_shards = n_shards
        assert batch % n_shards == 0
        self.local_batch = batch // n_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        docs = rng.integers(0, len(self.corpus),
                            size=(self.batch,))
        starts = rng.integers(
            0, max(self.corpus.shape[1] - self.seq - 1, 1),
            size=(self.batch,))
        lo = self.shard * self.local_batch
        hi = lo + self.local_batch
        toks = np.stack([
            self.corpus[d, s:s + self.seq + 1]
            for d, s in zip(docs[lo:hi], starts[lo:hi])])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator."""

    def __init__(self, batcher: TokenBatcher, start_step: int = 0,
                 depth: int = 2):
        self.batcher = batcher
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.batcher.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def dedup_corpus(corpus: np.ndarray, *, lam: int = 16, eps: float = 1.0,
                 max_docs: Optional[int] = None, device=None) -> np.ndarray:
    """Drop near-duplicate documents using the paper's machinery: each doc's
    windows are range-queried against a reference net of all previously kept
    windows; a doc whose windows overwhelmingly hit is a near-duplicate.

    Distances run on ``device`` (default: the card) through the counter's
    ``kernel`` backend, which carries Levenshtein tokens as int32 ids: an id
    outside int32 raises ``ValueError`` there."""
    from repro_torch.core.batch_engine import BatchEngine
    from repro_torch.core.counter import CountedDistance
    from repro_torch.core.refnet import ReferenceNet
    from repro_torch.core.segmentation import partition_windows
    from repro_torch.distances import get

    corpus = np.asarray(corpus)
    dist = get("levenshtein")
    docs = corpus[:max_docs] if max_docs else corpus
    kept = []
    net: Optional[ReferenceNet] = None
    data_rows = []
    for doc in docs:
        wins, _ = partition_windows([doc], lam)
        if net is None:
            kept.append(doc)
            data_rows = list(wins)
            table = np.stack(data_rows)
            net = ReferenceNet(dist, table, eps_prime=1.0, tight_bounds=True,
                               counter=CountedDistance(dist, table,
                                                       device=device)
                               ).build()
            continue
        # one engine batch probes every window of the doc concurrently
        # (hit sets and eval counts match the sequential per-window loop)
        probe = BatchEngine(net.counter).run(
            [net.range_query_plan(eps) for _ in wins], list(wins), eps)
        hits = sum(bool(h) for h in probe)
        if hits >= max(1, int(0.9 * len(wins))):
            continue  # near-duplicate: drop
        kept.append(doc)
        base = len(data_rows)
        data_rows.extend(list(wins))
        # rebuild counter over the grown window set (on the card: the whole
        # table is uploaded again), then insert new windows
        net.counter = CountedDistance(dist, np.stack(data_rows),
                                      device=device)
        net.data = net.counter.data
        for i in range(base, len(data_rows)):
            net.insert(i)
    return np.stack(kept)
