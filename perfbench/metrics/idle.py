"""Shared arithmetic of the ``device_idle_share.*`` readers."""


def share(run):
    tr = getattr(run, "trace", None)
    span = tr.span("perfbench.window") if tr is not None else None
    if span is None or not tr.has_device:
        return None
    a, b = span
    return (1.0 - tr.busy_in(a, b) / (b - a)) * 100.0
