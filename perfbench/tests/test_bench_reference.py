"""The plain references against hand-worked distances, against the
program's own numpy-order distances (bit for bit), and their controls."""

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.references import erp, levenshtein


def _lev(a: str, b: str) -> int:
    code = {c: i for i, c in enumerate(sorted(set(a + b)))}
    x = torch.tensor([[code[c] for c in a]], dtype=torch.int32)
    y = torch.tensor([[code[c] for c in b]], dtype=torch.int32)
    return int(levenshtein.pair_distances(x, y)[0])


@pytest.mark.parametrize("a, b, d", [
    ("kitten", "sitting", 3), ("flaw", "lawn", 2), ("abc", "abc", 0),
    ("abcd", "dcba", 4), ("a", "b", 1), ("intention", "execution", 5)])
def test_levenshtein_hand_worked(a, b, d):
    assert _lev(a, b) == d
    assert _lev(b, a) == d


@pytest.mark.parametrize("x, y, d", [
    ([[1.0, 0.0]], [[0.0, 1.0]], 2.0 ** 0.5),     # substitute: sqrt(2) < 2
    ([[0.0, 0.0], [3.0, 4.0]], [[0.0, 0.0]], 5.0),  # a gap costs |x - 0|
    ([[3.0, 4.0]], [[3.0, 4.0]], 0.0),
    ([[1.0, 0.0], [0.0, 2.0]], [[0.0, 2.0]], 1.0),  # gap (1, 0), then match
])
def test_erp_hand_worked(x, y, d):
    got = erp.pair_distances(torch.tensor([x]), torch.tensor([y]))
    assert float(got[0]) == pytest.approx(d, rel=1e-7)


def test_references_equal_the_programs_numpy_order_bit_for_bit():
    """The program holds every float distance to numpy's order (its
    ``np_backend``); the reference, written apart, agrees bit for bit, so
    a window at exactly ``eps`` is judged alike."""
    from perfbench.frozen.synthetic import mutate, proteins, trajectories
    from repro_torch.distances import np_backend
    tr = trajectories(400, seed=3)
    q = mutate(tr, 400, seed=4, rate=0.01)
    want = np_backend.batch_for("erp")(q, tr)
    got = erp.pair_distances(torch.as_tensor(q), torch.as_tensor(tr))
    assert np.array_equal(got.numpy(), np.asarray(want, np.float32))
    pr = proteins(400, seed=5)
    q = mutate(pr, 400, seed=6)
    want = np_backend.batch_for("levenshtein")(q, pr)
    got = levenshtein.pair_distances(torch.as_tensor(q), torch.as_tensor(pr))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))


def test_hits_and_controls():
    rng = np.random.default_rng(0)
    ws = rng.integers(0, 4, size=(50, 6)).astype(np.int32)
    qs = ws[:5].copy()
    qs[:, 0] = (qs[:, 0] + 1) % 4     # each query at distance 1 of its row
    exact = check.reference_hits(levenshtein, qs, ws, 1.0, "cpu",
                                 block_pairs=64)
    for i, h in enumerate(exact):
        assert i in h
    strict = check.reference_hits(levenshtein, qs, ws, 1.0, "cpu",
                                  control=True)
    got = check.compare([list(h) for h in strict], exact)
    assert got["mismatched_queries"] == 5 and got["added_hits"] == 0
    assert check.compare([list(h) for h in exact], exact)[
        "mismatched_queries"] == 0
    assert check.compare([None] * 5, exact)["unanswered_queries"] == 5
