"""Device distance evaluations per answered query: the fleet's
``device_stats["total_evals"]`` over the window."""


def read(run):
    return run.evals / run.answered if run.answered else None
