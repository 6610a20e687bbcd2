"""Set-up: process start to the first due request (data, the kernel's
library, the fleet's build, the warm-up)."""


def read(run):
    return run.t_window - run.t0
