"""Share of the measured window in which no operation ran on the device
(1 - the union of device activity over the window span, profiler)."""

from perfbench.metrics import idle


def read(run):
    return idle.share(run)
