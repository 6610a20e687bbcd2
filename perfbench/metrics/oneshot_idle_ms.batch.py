"""Device-idle milliseconds a batch while the innermost program span open
is a phase of the one-shot device query (``oneshot.*``, its waits
included): the program's spans on the profiler's clock
(``spans.attribute``), over the batches."""

from perfbench.metrics import spans


def read(run):
    return spans.idle_ms(run, "oneshot")
