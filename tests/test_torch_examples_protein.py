"""``examples/protein_search_torch.py`` against
``examples/protein_search.py`` on the CPU: ``proteins(2000)`` behind the
reference net, its tight variant, the cover tree and MV-5, each answering
ten queries at ε = 2 and 4.

Every character is equal: the evaluation fractions and hit counts of the
table and the identical-results line.  Every counted dispatch is one call
of the wavefront kernel's plain version.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_examples import (assert_same_lines, run_port,  # noqa: E402
                            run_reference)


def test_protein_search_prints_what_the_reference_prints(capsys,
                                                         monkeypatch):
    want = run_reference("protein_search", [], capsys, monkeypatch)
    got, res, calls = run_port("protein_search", [], capsys)
    assert_same_lines(got, want)
    for eps in (2.0, 4.0):
        hits = {name: [sorted(h) for h in rs.hits]
                for (name, e), rs in res["results"].items() if e == eps}
        assert len(hits) == 4
        assert all(h == hits["reference net"] for h in hits.values())
    assert calls.wavefront == calls.dispatches == sum(
        st["dispatches"] + st["build_dispatches"]
        for st in res["eval_stats"].values()) > 0
    assert calls.pairwise_l2 == 0
