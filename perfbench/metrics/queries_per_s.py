"""Queries answered over the whole window, to the end of the batch in
flight at the deadline."""


def read(run):
    if getattr(run, "elapsed", None) is None:
        return None
    return run.answered / run.elapsed
