"""Shared arithmetic of the ``wavefront_roofline.*`` readers."""

from perfbench.frozen import costs


def wavefront(run):
    tr = getattr(run, "trace", None)
    span = tr.span("perfbench.window") if tr is not None else None
    if span is None or not run.launches.rows:
        return None
    kernel_s = tr.kernel_s("wavefront_", span[0], float("inf"))
    if kernel_s <= 0.0:
        return None
    return run.launches.bound_s(costs) / kernel_s * 100.0
