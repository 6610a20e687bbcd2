"""The program's own spans (``repro_torch.spans``) on the device trace's
clock: the shared arithmetic of the ``*_idle_ms.batch``,
``oneshot_wait_ms.batch`` and ``build_plan_s`` readers.

Importing this module turns the program's tracer on; in a program that
has none, every reader here returns ``None``.  The harness loads
the per-layer readers, and so this module, only in a ``--trace 1`` run,
and before the build: the tracer then records from the build to the end
of a traced run, and stays off in every ``--trace 0`` run.

One clock.  The profiler's chrome trace gives times relative to a base
that :class:`perfbench.trace.Trace` drops, and the tracer reads
``time.monotonic_ns()``.  One anchor maps the second onto the first: the
start of the trace's ``perfbench.window`` range against ``run.t_window``,
``time.monotonic()`` read just inside that range.  The window's end is
the check: if the range's length and ``run.elapsed`` differ by more than
:data:`DRIFT_S`, the readers return ``None`` rather than misattribute.
Importing this module opens one profiler range while no profiler runs,
so that the window's range, the first one profiled, does not also pay
the operator lookup of the process's first range.

Attribution.  Every device-idle instant inside the window goes to the
innermost program span open then: a span's share is the idle in its
interval less the idle in its children's, and what no span covers is
left outside.  The window's idle is the sum of the shares and what is
left outside.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np
import torch

from perfbench.trace import union

try:
    from repro_torch import spans as program_spans
except ImportError:     # a program without the tracer: nothing to read
    program_spans = None
else:
    program_spans.enable()
# the first profiler range of a process resolves its operator (about 1 ms
# on a CPU core); left to the window's own range, that time would fall
# between the range's start and ``run.t_window`` and shift the anchor
with torch.profiler.record_function("perfbench.spans"):
    pass

#: the most the window's length may differ between the two clocks
DRIFT_S = 1e-3
#: the program's layers by the prefix of their spans' names
LAYERS = {"oneshot": "oneshot.", "fleet": "fleet.", "facade": "retriever.",
          "gc": "python.gc"}
#: the spans whose self time, outside ``counter.eval``, is the build's
#: host plan code
PLAN = ("refnet.build", "refnet.flatten")


def _idle_cdf(trace, lo: float, hi: float):
    """Breakpoints of the device-idle seconds in ``[lo, t]`` as ``t``
    runs over the window (piecewise linear between them)."""
    busy = np.asarray([(max(a, lo), min(b, hi)) for a, b in
                       union([(a, b) for a, b, _ in trace.device])
                       if b > lo and a < hi], np.float64).reshape(-1, 2)
    if not len(busy):
        return np.array([lo, hi]), np.array([0.0, hi - lo])
    gaps = busy[:, 0] - np.concatenate([[lo], busy[:-1, 1]])
    at = np.cumsum(gaps)
    xs = np.concatenate([[lo], busy.reshape(-1), [hi]])
    ys = np.concatenate([[0.0], np.repeat(at, 2),
                         [at[-1] + hi - busy[-1, 1]]])
    return xs, ys


def attribute(trace, recs, t_window: float, elapsed: float
              ) -> Optional[Dict]:
    """The window's device idle split by the innermost program span, or
    ``None`` without a window or when the anchor drifts.  Seconds, on the
    trace's clock: ``idle`` (the window's), ``by_name`` (each span name's
    share), ``outside`` (under no span), ``batch_idle`` (inside the
    ``perfbench.batch`` ranges) and ``batch_covered`` (of it, under some
    span), ``wait`` (host seconds inside ``oneshot.wait``), ``records``
    (spans that overlap the window), ``wait_by_phase`` (the idle under
    ``oneshot.wait`` by the phase it sits in) and ``drift``."""
    window = trace.span("perfbench.window")
    if window is None or t_window is None or elapsed is None:
        return None
    lo, hi = window
    drift = (hi - lo) - elapsed
    if abs(drift) > DRIFT_S:
        return None
    shift = lo - t_window
    start = np.clip(recs.start_ns * 1e-9 + shift, lo, hi)
    end = np.clip(recs.end_ns * 1e-9 + shift, lo, hi)
    xs, ys = _idle_cdf(trace, lo, hi)

    def idle(a, b):
        return np.maximum(np.interp(b, xs, ys) - np.interp(a, xs, ys), 0.0)

    own = idle(start, end)
    row = recs.rows(recs.parent)
    kid = np.flatnonzero(row >= 0)
    p = row[kid]
    np.subtract.at(own, p, idle(np.maximum(start[kid], start[p]),
                                np.minimum(end[kid], end[p])))
    by_name: Dict[str, float] = {}
    for name in np.unique(recs.name):
        by_name[str(name)] = float(own[recs.name == name].sum())
    # roots (one serving thread: disjoint) against the batch ranges
    roots = np.flatnonzero((row < 0) & (end > start))
    bat = np.asarray(union(trace.spans.get("perfbench.batch", [])),
                     np.float64).reshape(-1, 2)
    batch_idle = covered = 0.0
    if len(bat):
        done = np.concatenate([[0.0], np.cumsum(idle(bat[:, 0],
                                                     bat[:, 1]))])

        def inside(t):
            """Idle seconds in ``[lo, t]`` that lie inside a batch."""
            k = np.searchsorted(bat[:, 1], t, side="right")
            at = np.minimum(k, len(bat) - 1)
            part = idle(bat[at, 0], np.minimum(t, bat[at, 1]))
            return done[k] + np.where(k < len(bat), part, 0.0)

        batch_idle = float(done[-1])
        covered = float((inside(end[roots]) - inside(start[roots])).sum())
    total = float(ys[-1])
    waits = recs.name == "oneshot.wait"
    wait_by_phase: Dict[str, float] = {}
    for i in np.flatnonzero(waits & (row >= 0)):
        phase = str(recs.name[row[i]])
        wait_by_phase[phase] = wait_by_phase.get(phase, 0.0) + own[i]
    return {"idle": total, "by_name": by_name,
            "outside": total - float(idle(start[roots], end[roots]).sum()),
            "batch_idle": batch_idle, "batch_covered": covered,
            "wait": float((end[waits] - start[waits]).sum()),
            "wait_by_phase": wait_by_phase,
            "records": int((end > start).sum()), "drift": drift}


def layer_s(att: Dict, layer: str) -> float:
    """Idle seconds under the spans of one of :data:`LAYERS`."""
    prefix = LAYERS[layer]
    return sum(s for n, s in att["by_name"].items() if n.startswith(prefix))


def _log(att: Optional[Dict], recs) -> None:
    if att is None:
        print(f"[perfbench] program spans: not attributed ({len(recs)} "
              f"records, overflow {recs.overflow}; no window, or the "
              f"anchor drifted by more than {DRIFT_S * 1e3:g} ms)",
              file=sys.stderr, flush=True)
        return
    parts = {k: layer_s(att, k) for k in LAYERS}
    other = att["idle"] - att["outside"] - sum(parts.values())
    share = (att["batch_covered"] / att["batch_idle"] * 100.0
             if att["batch_idle"] > 0 else float("nan"))
    print(f"[perfbench] program spans: {att['records']} records in the "
          f"window ({len(recs)} kept, overflow {recs.overflow}), anchor "
          f"drift {att['drift'] * 1e6:.1f} us; window idle "
          f"{att['idle']:.6f} s: "
          + ", ".join(f"{k} {v:.6f}" for k, v in parts.items())
          + f", other spans {other:.6f}, outside spans "
          f"{att['outside']:.6f}; batch-range idle {att['batch_idle']:.6f}"
          f" s, {share:.2f}% under a span; host in oneshot.wait "
          f"{att['wait']:.6f} s; idle by span: "
          + ", ".join(f"{n} {v:.6f}" for n, v in sorted(
              att["by_name"].items(), key=lambda t: -t[1]) if v > 0)
          + "; oneshot.wait idle by phase: "
          + ", ".join(f"{n} {v:.6f}" for n, v in sorted(
              att["wait_by_phase"].items(), key=lambda t: -t[1])),
          file=sys.stderr, flush=True)


def program(run) -> Optional[Dict]:
    """:func:`attribute` for a run's trace and the tracer's records, read
    once a run (``None`` without a trace, batches or every record)."""
    if not hasattr(run, "program_spans"):
        tr = getattr(run, "trace", None)
        att = None
        if (program_spans is not None and tr is not None
                and getattr(run, "batches", 0)):
            recs = program_spans.records()
            if recs.overflow == 0:
                att = attribute(tr, recs, getattr(run, "t_window", None),
                                getattr(run, "elapsed", None))
            _log(att, recs)
        run.program_spans = att
    return run.program_spans


def idle_ms(run, layer: str) -> Optional[float]:
    """Device-idle milliseconds a batch under one of :data:`LAYERS`."""
    att = program(run)
    return None if att is None else layer_s(att, layer) / run.batches * 1e3


def build_plan_s(recs, since_ns: int, until_ns: int) -> float:
    """Self time of the build's plan spans outside ``counter.eval``,
    summed over the spans (so over shards) that ran in
    ``[since_ns, until_ns]``."""
    own = recs.self_ns(children=("counter.eval",))
    keep = (np.isin(recs.name, PLAN) & (recs.start_ns >= since_ns)
            & (recs.end_ns <= until_ns))
    return float(own[keep].sum()) * 1e-9
