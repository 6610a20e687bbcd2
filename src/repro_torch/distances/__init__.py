from repro_torch.distances.base import (  # noqa: F401
    Distance, get, names, register, resolve, require_consistent,
    require_metric)
