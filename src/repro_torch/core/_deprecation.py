"""Deprecation plumbing for the legacy public entry points.

Since the ``repro_torch.retrieval`` facade became the canonical API, direct
construction of the old entry points (``SubsequenceMatcher``,
``ElasticIndex``, ``EmbeddingRetriever``) is deprecated.  The classes are
still the implementation the facade delegates to, so the warning is only
emitted for *direct* construction — the facade wraps its internal
constructions in :func:`facade_construction`, which suppresses it.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

_state = threading.local()


@contextlib.contextmanager
def facade_construction():
    """Suppress legacy-constructor warnings for facade-internal builds."""
    prev = getattr(_state, "internal", False)
    _state.internal = True
    try:
        yield
    finally:
        _state.internal = prev


def warn_legacy(entry_point: str) -> None:
    """Emit the deprecation warning unless the facade is constructing."""
    if getattr(_state, "internal", False):
        return
    warnings.warn(
        f"direct construction of {entry_point} is deprecated; build it "
        "through the facade instead: "
        "repro_torch.retrieval.Retriever.build(RetrievalConfig(...), data)",
        DeprecationWarning, stacklevel=3)


def warn_moved(old: str, new: str) -> None:
    """Deprecation for relocated internals (e.g. ``_batch_dist`` -> the
    kernel registry).  Same suppression rule as the constructor shims, so
    facade-internal delegation stays silent while external callers get one
    release of warning."""
    if getattr(_state, "internal", False):
        return
    warnings.warn(
        f"{old} has moved to {new}; this delegation shim will be removed "
        "in the next release", DeprecationWarning, stacklevel=3)
