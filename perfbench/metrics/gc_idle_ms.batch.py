"""Device-idle milliseconds a batch inside pauses of Python's collector
(``python.gc`` spans, whatever they interrupted): the program's spans on
the profiler's clock (``spans.attribute``), over the batches."""

from perfbench.metrics import spans


def read(run):
    return spans.idle_ms(run, "gc")
