"""Device-idle milliseconds a batch while the innermost program span open
is the fleet's one-shot wrapper (``fleet.oneshot``'s own code, and
``fleet.map_hits``, which maps each shard's hit mask to global ids): the
program's spans on the profiler's clock (``spans.attribute``), over the
batches."""

from perfbench.metrics import spans


def read(run):
    return spans.idle_ms(run, "fleet")
