"""The wavefront kernel's share of its roofline in the window: the least
time of every launch (frozen ``wavefront_cost`` at the H100's published
peaks) over the kernel's device time (profiler)."""

from perfbench.metrics import roofline


def read(run):
    return roofline.wavefront(run)
