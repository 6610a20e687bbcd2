"""The port's quickstart flow under host execution (the sequential
per-segment frontier drive) against the JAX reference; the fixture, the
checks and their tolerances are those of ``test_torch_retrieval.py``, whose
batched cases run on another worker."""

import pytest

pytest.importorskip("torch")

from test_torch_retrieval import check_quickstart, quickstart  # noqa: E402,F401


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_quickstart_three_query_types_match_reference_host(quickstart,
                                                           backend):
    check_quickstart(quickstart, backend, "host")
