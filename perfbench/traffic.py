"""The one general traffic generator: every cell's file of parameters is
read here.  Streams of randomness are derived from ``--seed`` by name, so
the same seed gives the same database and queries.

Query kinds (a cell's ``query.kind``): ``mutate`` -- database rows with a
share ``rate`` of tokens redrawn, or Gaussian noise of ``rate`` times the
data's standard deviation (the frozen ``mutate``).
"""

from __future__ import annotations

import numpy as np

from perfbench.frozen.synthetic import mutate

#: a stream's place here is part of what a seed means: append, never
#: reorder (``arrivals`` is kept for the open-loop traffic of a later cell)
STREAMS = ("data", "queries", "arrivals", "warmup", "sample")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), STREAMS.index(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def queries(spec: dict, data: np.ndarray, n: int, seed: int) -> np.ndarray:
    """``n`` query windows as a cell's ``query`` entry describes them."""
    if spec["kind"] == "mutate":
        return mutate(data, n, seed, rate=spec["rate"])
    raise ValueError(f"unknown query kind {spec['kind']!r}")
