"""The cell's ``Retriever.build`` on the host's clock, ended by a device
synchronisation.  The build runs unprofiled in every run, so the traced
run reads the same build that ``setup_s`` holds."""


def read(run):
    return run.build_s
