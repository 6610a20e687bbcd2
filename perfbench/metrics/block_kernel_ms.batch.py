"""Device milliseconds a batch of the wavefront kernel's block schedule:
the summed device time of the kernels whose name holds
``wavefront_block_kernel`` and that start inside the window (profiler),
over the batches.  Read only where the program's spans record a
``wavefront.block`` launch inside the window, so that it reads what the
program says ran on that schedule."""

import numpy as np

from perfbench.metrics import spans


def _block_launches(run) -> bool:
    """Whether a ``wavefront.block`` span starts inside the window."""
    if spans.program_spans is None:
        return False
    recs = spans.program_spans.records()
    lo = int(run.t_window * 1e9)
    hi = int((run.t_window + run.elapsed) * 1e9)
    return bool(np.any((recs.name == "wavefront.block")
                       & (recs.start_ns >= lo) & (recs.start_ns <= hi)))


def read(run):
    tr = getattr(run, "trace", None)
    window = tr.span("perfbench.window") if tr is not None else None
    if (window is None or not tr.has_device or not getattr(run, "batches", 0)
            or not _block_launches(run)):
        return None
    lo, hi = window
    return tr.kernel_s("wavefront_block_kernel", lo, hi) / run.batches * 1e3
