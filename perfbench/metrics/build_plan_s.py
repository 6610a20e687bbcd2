"""Seconds of the refnet build's host plan code: the self time of
``refnet.build`` and ``refnet.flatten`` outside ``counter.eval`` (device
evaluation and the wait for it), summed over the shards, from the
program's own timers.  The build stays unprofiled, as ``index_build_s``'s
reading of it is."""

from perfbench.metrics import spans


def read(run):
    if spans.program_spans is None or not hasattr(run, "build_s"):
        return None
    recs = spans.program_spans.records()
    if recs.overflow:
        return None
    until = getattr(run, "t_window", None)
    return spans.build_plan_s(
        recs, int(run.t0 * 1e9),
        int(until * 1e9) if until is not None else recs.end_ns.max(initial=0))
