"""`repro_torch.retrieval` — the canonical entry point to the port.

One declarative :class:`RetrievalConfig`, one :class:`Retriever` facade
over the ported index kinds and execution engines (host / batched frontier
engine / elastic fleet, with the continuous-batching serve engine on top),
with pluggable registries for third-party distances and indexes.
See ``facade.py`` for the query-plan API.
"""

from repro_torch.retrieval.config import EXECUTIONS, RetrievalConfig  # noqa: F401
from repro_torch.retrieval.facade import (  # noqa: F401
    QueryPlan, ResultSet, Retriever)
from repro_torch.retrieval.registry import (  # noqa: F401
    IndexSpec, distance_names, index_names, register_distance,
    register_index, resolve_distance, resolve_index, unregister_distance,
    unregister_index)
