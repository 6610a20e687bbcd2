"""``examples/trajectory_search_torch.py`` against
``examples/trajectory_search.py`` on the CPU: the DTW-on-refnet validation
error, then the longest match under discrete Fréchet and ERP on the
reference net and DTW on the linear scan (the wavefront's float modes).

Every character is equal but the three distances, which may differ by one
unit in their last printed digit (f32 torch against the reference's numpy
wavefront); trajectory ids, offsets and evaluation counts are exact.  Every
counted dispatch is one call of the wavefront kernel's plain version.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_examples import (assert_same_lines, run_port,  # noqa: E402
                            run_reference)


def test_trajectory_search_prints_what_the_reference_prints(capsys,
                                                            monkeypatch):
    want = run_reference("trajectory_search", [], capsys, monkeypatch)
    got, res, calls = run_port("trajectory_search", [], capsys)
    assert_same_lines(got, want, loose=r"d=")
    assert res["validation"] and "metric" in res["validation"]
    assert set(res["results"]) == {"frechet", "erp", "dtw"}
    assert all(rs.first.seq_id == 2 for rs in res["results"].values())
    assert calls.wavefront == calls.dispatches == sum(
        st["dispatches"] + st["build_dispatches"]
        for st in res["eval_stats"].values()) > 0
    assert calls.pairwise_l2 == 0
