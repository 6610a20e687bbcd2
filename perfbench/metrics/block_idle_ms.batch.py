"""Device-idle milliseconds a batch while the innermost program span open
is ``wavefront.block`` (the host work of a launch on the wavefront
kernel's block schedule, while the card waits): the program's spans on
the profiler's clock (``spans.attribute``), over the batches.  A program
without the schedule's counter has no such span: nothing is read."""

from perfbench.metrics import spans


def read(run):
    if getattr(run.launches.wf, "SCHEDULE_ROWS", None) is None:
        return None
    att = spans.program(run)
    if att is None:
        return None
    return att["by_name"].get("wavefront.block", 0.0) / run.batches * 1e3
