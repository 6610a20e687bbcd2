"""Distance evaluations of the fleet's build (the shards' counters'
``build`` bucket)."""


def read(run):
    return run.build_evals
