"""Closed-loop batches: one caller sends a batch of range queries and
waits for the answers before sending the next, through the program's
one-shot stacked device query (``Retriever.batch(qs).via(cell["via"])``).

The batches come from a pool made from the seed before the build; the
loop cycles through it if it runs out.  The batch in flight at the
deadline finishes and the time runs to its end.  The reference judges a
sample of the answered queries drawn from the seed.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench import traffic


def plan(run) -> None:
    cell = run.cell
    B, P = cell["batch"], cell["pool_batches"]
    run.pool = traffic.queries(cell["query"], run.data, B * P,
                               run.stream("queries")).reshape(
        P, B, *run.data.shape[1:])
    run.warm_batches = traffic.queries(
        cell["query"], run.data, B * cell["warmup_batches"],
        run.stream("warmup")).reshape(-1, B, *run.data.shape[1:])
    run.sample_order = np.random.default_rng(
        run.stream("sample")).permutation(B * P)


def _answer(run, qs):
    cell = run.cell
    return run.retriever.batch(qs).via(cell["via"]).range(cell["eps"]).hits


def warm(run) -> None:
    for qs in run.warm_batches:
        _answer(run, qs)


def window(run) -> None:
    P, B = run.pool.shape[:2]
    stats = run.retriever.elastic()
    evals0 = stats.device_stats["total_evals"]
    answers = {}
    batches = failed = 0
    rf = torch.profiler.record_function
    with rf("perfbench.window"):
        t_start = time.monotonic()
        run.t_window = t_start
        deadline = t_start + run.seconds
        t = t_start
        while t < deadline:
            k = batches % P
            with rf("perfbench.batch"):
                try:
                    hits = _answer(run, run.pool[k])
                except Exception as exc:  # noqa: BLE001 -- counted as failed
                    print(f"[perfbench] batch failed: {exc!r}",
                          file=sys.stderr)
                    hits = None
            t = time.monotonic()
            batches += 1
            if hits is None or len(hits) != B:
                failed += B
                answers.pop(k, None)
            else:
                answers[k] = hits
    run.elapsed = t - t_start
    run.batches = batches
    run.attempted = batches * B
    run.failed = failed
    run.answered = run.attempted - failed
    run.evals = stats.device_stats["total_evals"] - evals0
    run.answers_by_batch = answers


def _sample(run, answered_only: bool):
    P, B = run.pool.shape[:2]
    n = run.cell["sample_queries"]
    ids = run.sample_order
    if answered_only:
        seen = np.zeros(P * B, bool)
        for k in run.answers_by_batch:
            seen[k * B:(k + 1) * B] = True
        ids = ids[seen[ids]]
    return ids[:n]


def checked(run):
    B = run.pool.shape[1]
    ids = _sample(run, answered_only=True)
    flat = run.pool.reshape(-1, *run.pool.shape[2:])
    answers = [run.answers_by_batch[i // B][i % B] for i in ids]
    return flat[ids], answers


def control_queries(run):
    flat = run.pool.reshape(-1, *run.pool.shape[2:])
    return flat[_sample(run, answered_only=False)]
