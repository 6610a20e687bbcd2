"""Device-busy milliseconds per batch of the one-shot query: the union of
device activity inside the benchmark's batch spans (profiler), over the
batches."""


def read(run):
    tr = getattr(run, "trace", None)
    if tr is None or not tr.has_device or not run.batches:
        return None
    busy = sum(tr.busy_in(a, b) for a, b in tr.spans.get("perfbench.batch",
                                                         []))
    return busy / run.batches * 1e3
