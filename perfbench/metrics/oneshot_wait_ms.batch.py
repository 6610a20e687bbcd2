"""Host milliseconds a batch spent blocked on the card inside the one-shot
query (``oneshot.wait`` spans: each nonzero, boolean index, sum read back
and the hit mask's copy), inside the measured window, over the batches."""

from perfbench.metrics import spans


def read(run):
    att = spans.program(run)
    return None if att is None else att["wait"] / run.batches * 1e3
