"""Open-loop Poisson load generation for the serve engine.

Open-loop means arrivals are scheduled ahead of time from the target rate
and submitted on schedule *regardless of completions* — the generator
never waits for the engine, so queueing delay under overload is measured
honestly instead of being hidden by closed-loop back-pressure.

Two consumption modes share one schedule:

* :func:`poisson_schedule` — deterministic, seeded arrival times; the
  virtual-clock serving check (``chip_smoke.py``'s serve phase) feeds these
  straight into :meth:`~repro_torch.serve.engine.ServeEngine.run_schedule`,
  so the count-strict gate sees identical arrivals every run.
* :class:`OpenLoopLoadGen` — a wall-clock thread that submits the same
  schedule against a running engine for real latency percentiles.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np


def poisson_schedule(qps: float, duration: float, *,
                     seed: int = 0) -> np.ndarray:
    """Arrival times of a Poisson process at rate ``qps`` over
    ``[0, duration)`` — i.i.d. exponential gaps, deterministic per seed."""
    if qps <= 0:
        raise ValueError(f"qps must be positive; got {qps}")
    rng = np.random.default_rng(seed)
    # over-draw, then trim: P(fewer than 4x expected) is astronomically high
    n = max(16, int(4 * qps * duration))
    gaps = rng.exponential(1.0 / qps, size=n)
    t = np.cumsum(gaps)
    out = t[t < duration]
    while len(t) and t[-1] < duration:  # pathological seed: extend
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / qps, size=n))])
        out = t[t < duration]
    return np.asarray(out, np.float64)


class OpenLoopLoadGen:
    """Submit a fixed query list on a wall-clock Poisson schedule.

    ``start()`` launches the submission thread; ``join()`` waits for the
    schedule to drain and returns the submitted
    :class:`~repro_torch.serve.queue.Request` handles (completion is the
    engine's business — call ``req.result()`` / ``engine.close(drain=True)``
    to wait for answers)."""

    def __init__(self, engine, queries: Sequence[np.ndarray], qps: float,
                 *, eps: Optional[float] = None, seed: int = 0):
        self.engine = engine
        self.queries = [np.asarray(q) for q in queries]
        self.eps = eps
        # exactly ONE arrival per query (i.i.d. exponential gaps at rate
        # qps) — a duration-trimmed draw could come up short and silently
        # drop submissions from the tail of the list
        rng = np.random.default_rng(seed)
        self.schedule = np.cumsum(
            rng.exponential(1.0 / qps, size=len(self.queries)))
        self.requests: List[object] = []
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        t0 = time.monotonic()
        for q, at in zip(self.queries, self.schedule):
            delay = t0 + float(at) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            self.requests.append(self.engine.submit(q, eps=self.eps))

    def start(self) -> "OpenLoopLoadGen":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> List[object]:
        assert self._thread is not None, "start() first"
        self._thread.join(timeout)
        return self.requests
