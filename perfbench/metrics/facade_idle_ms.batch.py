"""Device-idle milliseconds a batch while the innermost program span open
is the facade's (``retriever.range``'s own code): the program's spans on
the profiler's clock (``spans.attribute``), over the batches."""

from perfbench.metrics import spans


def read(run):
    return spans.idle_ms(run, "facade")
