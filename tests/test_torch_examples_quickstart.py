"""``examples/quickstart_torch.py`` against ``examples/quickstart.py`` on
the CPU: the five-step query through the facade (Levenshtein refnet,
``lam=16``, ``tight_bounds``), all three query types.

The port prints what the reference prints, every character: the windows
indexed, the 569 type I pairs with their evaluations and dispatches, the
type II longest subsequence and the type III nearest pair (Levenshtein
distances are integers, so nothing is loose).  Every counted dispatch is
one call of the wavefront kernel's plain version (on the card, one
launch), and ``pairwise_l2`` is never called.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_examples import (assert_same_lines, run_port,  # noqa: E402
                            run_reference)


def test_quickstart_prints_what_the_reference_prints(capsys, monkeypatch):
    want = run_reference("quickstart", [], capsys, monkeypatch)
    got, res, calls = run_port("quickstart", [], capsys)
    assert_same_lines(got, want)
    st = res["eval_stats"]
    assert calls.wavefront == calls.dispatches \
        == st["dispatches"] + st["build_dispatches"] > 0
    assert calls.pairwise_l2 == 0
    best = res["longest"].first
    assert (best.seq_id, best.q_start, best.q_len) == (3, 20, 40)
    assert len(res["range"]) == 569
