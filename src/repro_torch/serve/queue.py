"""Async request queue for the continuous-batching serve engine.

A :class:`Request` is one range query's full serving record: the query
window, its ε, and the lifecycle timestamps the latency accounting is
built from —

* ``t_submit``  — entered the queue (the load generator's arrival time);
* ``t_admit``   — pulled off the queue and admitted to the shared
  frontier cadence (plans primed; joins at the next round boundary);
* ``t_first_dispatch`` — first merged round that carried this request's
  rows (queue delay = ``t_first_dispatch - t_submit``);
* ``t_complete`` — all shard-local plans exhausted, hits finalized (or
  the request failed: ``error`` holds the exception the serving loop hit,
  and :meth:`Request.result` raises it).

The :class:`RequestQueue` itself is a small thread-safe FIFO: producers
(:class:`~repro_torch.serve.loadgen.OpenLoopLoadGen`, CLI threads, tests) call
:meth:`~RequestQueue.submit`; the engine's tick drains it with
:meth:`~RequestQueue.take` up to the admission budget.  Timestamps are
caller-supplied so the same machinery serves both wall-clock serving and
the deterministic virtual-clock benchmarks.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One in-flight range query and its latency accounting row."""
    rid: int
    query: np.ndarray
    eps: float
    tag: Optional[object] = None
    t_submit: float = 0.0
    t_admit: float = math.nan
    t_first_dispatch: float = math.nan
    t_complete: float = math.nan
    rounds: int = 0                       # merged rounds this request rode in
    hits: Optional[List[int]] = None      # sorted global window ids
    error: Optional[BaseException] = None  # why serving failed, if it did
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def finish(self, hits: List[int], now: float) -> None:
        self.hits = hits
        self.t_complete = now
        self._done.set()

    def fail(self, error: BaseException, now: float) -> None:
        """Complete the request as failed: :meth:`result` raises."""
        self.error = error
        self.t_complete = now
        self._done.set()

    @property
    def failed(self) -> bool:
        return self.error is not None

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until served; returns the sorted global hit ids, or raises
        if serving failed."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not served in time")
        if self.error is not None:
            raise RuntimeError(
                f"request {self.rid} failed: {self.error!r}") from self.error
        assert self.hits is not None
        return self.hits

    @property
    def latency(self) -> float:
        """End-to-end: submit -> complete."""
        return self.t_complete - self.t_submit

    @property
    def queue_delay(self) -> float:
        """Submit -> first merged round carrying this request's rows."""
        return self.t_first_dispatch - self.t_submit


class RequestQueue:
    """Thread-safe FIFO between producers and the engine tick."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: collections.deque = collections.deque()
        self._next_rid = 0
        self.submitted = 0

    def submit(self, query: np.ndarray, eps: float, *,
               tag: Optional[object] = None, now: float = 0.0) -> Request:
        req = Request(rid=-1, query=np.asarray(query), eps=float(eps),
                      tag=tag, t_submit=float(now))
        with self._lock:
            req.rid = self._next_rid
            self._next_rid += 1
            self._items.append(req)
            self.submitted += 1
        return req

    def drain(self) -> List[Request]:
        """Pop every queued request."""
        with self._lock:
            out = list(self._items)
            self._items.clear()
        return out

    def take(self, limit: int) -> List[Request]:
        """Pop up to ``limit`` requests in arrival order."""
        out: List[Request] = []
        with self._lock:
            while self._items and len(out) < limit:
                out.append(self._items.popleft())
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
