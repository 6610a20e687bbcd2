"""Pluggable registries behind the ``repro_torch.retrieval`` facade.

Two axes of genericity (Novak et al., arXiv:1206.2510: separate *what* —
the distance — from *how* — the index):

* **Distances** live in the global registry of ``repro_torch.distances``;
  :func:`register_distance` re-exports registration in decorator-friendly
  form so third parties can add a distance and immediately name it in a
  :class:`~repro_torch.retrieval.config.RetrievalConfig`.
* **Index kinds** are described by an :class:`IndexSpec` — a factory plus
  the declarative facts the facade needs (does it require metricity, does
  it support the cohort bulk loader, which config fields map onto its
  constructor, how are database rows / query rows shaped).  The built-in
  kinds ported so far (``refnet``, ``linear``) register themselves here;
  ``@register_index("mykind")`` adds new ones.  The reference's other
  kinds (``covertree``, ``mv``, ``embedding``) are not ported yet and
  raise ``NotImplementedError`` when named.

Factories import the core classes lazily so this module stays import-cycle
free (core modules may import the registry to resolve index kinds).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.distances import base as dist_base


# -- distance registry --------------------------------------------------------

def register_distance(obj):
    """Register a distance with the global registry and return it.

    Usable three ways: ``register_distance(distance_instance)``, as a
    decorator over a zero-argument factory function returning a
    :class:`~repro_torch.distances.base.Distance`, or via
    ``repro_torch.distances.base.register`` directly.
    """
    if isinstance(obj, dist_base.Distance):
        return dist_base.register(obj)
    made = obj()
    if not isinstance(made, dist_base.Distance):
        raise TypeError(
            "@register_distance expects a Distance or a zero-arg factory "
            f"returning one; got {made!r}")
    return dist_base.register(made)


def unregister_distance(name: str) -> None:
    """Remove a distance from the global registry (test hygiene)."""
    dist_base._REGISTRY.pop(name, None)


def distance_names():
    return dist_base.names()


resolve_distance = dist_base.resolve


# -- index registry -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Everything the facade needs to know about an index kind."""

    name: str
    #: ``factory(dist, data, *, counter=None, **tuning) -> index`` where the
    #: index exposes ``build()`` (and ``build_batched()`` when ``bulk``),
    #: ``range_query(q, eps, q_len, *, lb_cascade)`` and
    #: ``range_query_plan(eps)`` on the frontier-plan substrate.
    factory: Callable
    #: triangle inequality required (paper §5) — checked at config time
    requires_metric: bool = True
    #: supports the cohort bulk loader (``build_batched``)
    bulk: bool = False
    #: config-like object -> constructor kwargs
    tuning: Callable = lambda cfg: {}
    #: reshape the caller's database before the counter sees it
    prepare_data: Callable = np.asarray
    #: reshape one query before it meets ``range_query`` / the engine
    prepare_query: Callable = np.asarray


_INDEXES: Dict[str, IndexSpec] = {}


def register_index(name: str, *, requires_metric: bool = True,
                   bulk: bool = False, tuning: Optional[Callable] = None,
                   prepare_data: Optional[Callable] = None,
                   prepare_query: Optional[Callable] = None):
    """Decorator registering an index factory under ``name``.

    The decorated callable becomes :attr:`IndexSpec.factory`; the keyword
    facts describe it to the facade (see :class:`IndexSpec`).
    """
    if name in _INDEXES:
        raise ValueError(f"index kind {name!r} already registered")

    def deco(factory: Callable) -> Callable:
        _INDEXES[name] = IndexSpec(
            name=name, factory=factory, requires_metric=requires_metric,
            bulk=bulk, tuning=tuning or (lambda cfg: {}),
            prepare_data=prepare_data or np.asarray,
            prepare_query=prepare_query or np.asarray)
        return factory

    return deco


def unregister_index(name: str) -> None:
    """Remove an index kind (test hygiene)."""
    _INDEXES.pop(name, None)


#: index kinds of the reference that this port does not have yet
UNPORTED_INDEXES = {
    "covertree": "ROADMAP.md Queue 1: other index kinds",
    "mv": "ROADMAP.md Queue 1: other index kinds",
    "embedding": "ROADMAP.md Queue 1: LM/embedding stack",
}


def resolve_index(name: str) -> IndexSpec:
    if name not in _INDEXES and name in UNPORTED_INDEXES:
        raise NotImplementedError(
            f"index kind {name!r} is not ported yet "
            f"({UNPORTED_INDEXES[name]})")
    if name not in _INDEXES:
        raise KeyError(
            f"unknown index kind {name!r}; have {sorted(_INDEXES)}")
    return _INDEXES[name]


def index_names():
    return sorted(_INDEXES)


# -- built-in index kinds -----------------------------------------------------

def _refnet_tuning(cfg) -> dict:
    return dict(eps_prime=cfg.eps_prime, num_max=cfg.num_max,
                tight_bounds=cfg.tight_bounds)


@register_index("refnet", requires_metric=True, bulk=True,
                tuning=_refnet_tuning)
def _make_refnet(dist, data, *, counter=None, **kw):
    from repro_torch.core.refnet import ReferenceNet
    return ReferenceNet(dist, data, counter=counter, **kw)


@register_index("linear", requires_metric=False)
def _make_linear(dist, data, *, counter=None, **kw):
    from repro_torch.core.matching import LinearScanIndex
    return LinearScanIndex(dist, data, counter=counter, **kw)
