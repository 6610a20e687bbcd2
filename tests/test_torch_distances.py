"""The port's distance registry against the JAX reference's.

Every registered distance's ``pair`` / ``batch`` / ``matrix`` (the torch
anti-diagonal engine of ``repro_torch/distances/_wavefront.py``) on the
shapes of the reference's own distance tests, ragged lengths included, with
the same seeded numpy inputs on both sides.

Tolerance: Levenshtein and Hamming are bit-equal; the float distances agree
to ``rtol = atol = 1e-5``.  The reference's jnp engine and the port's torch
engine run the same f32 recurrence, but XLA may fuse the cost tile and
order the feature-axis sum and ERP's border cumsum differently from torch,
which moves last bits that the DP then adds up along the path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import distances as ref  # noqa: E402
from repro_torch import distances as port  # noqa: E402
from repro_torch.core.consistency import check_consistency  # noqa: E402

ALIGN = ["dtw", "erp", "frechet", "levenshtein"]
ALL = ["euclidean", "hamming"] + ALIGN
EXACT = {"levenshtein", "hamming"}
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand_pair(name, lx, ly, rng, d=2):
    dist = ref.get(name)
    if not dist.variable_length:
        ly = lx
    if dist.string:
        return rng.integers(0, 6, size=(lx,)), rng.integers(0, 6, size=(ly,))
    return (rng.normal(size=(lx, d)).astype(np.float32),
            rng.normal(size=(ly, d)).astype(np.float32))


def _close(name, got, want):
    got = np.asarray(got.cpu().numpy() if isinstance(got, torch.Tensor)
                     else got)
    want = np.asarray(want)
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_registry_names_and_flags_match_reference():
    assert port.names() == ref.names()
    for name in ref.names():
        a, b = ref.get(name), port.get(name)
        for flag in ("metric", "consistent", "string", "variable_length"):
            assert getattr(a, flag) == getattr(b, flag), (name, flag)
        assert (a.lower_bound is None) == (b.lower_bound is None)
        assert (a.envelope_bound is None) == (b.envelope_bound is None)
    with pytest.raises(ValueError):
        port.require_metric("dtw")


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("lx,ly", [(1, 1), (3, 9), (8, 8), (13, 5),
                                   (20, 20)])
def test_pair_matches_reference(name, lx, ly):
    rng = np.random.default_rng(lx * 31 + ly)
    x, y = _rand_pair(name, lx, ly, rng)
    _close(name, port.get(name).pair(x, y, device="cpu"),
           ref.get(name).pair(x, y))


@pytest.mark.parametrize("name", ALL)
def test_batch_and_matrix_match_reference(name):
    rng = np.random.default_rng(1234)
    dist = ref.get(name)
    B, L = 16, 10
    if dist.string:
        xs = rng.integers(0, 5, size=(B, L))
        ys = rng.integers(0, 5, size=(B, L))
    else:
        xs = rng.normal(size=(B, L, 3)).astype(np.float32)
        ys = rng.normal(size=(B, L, 3)).astype(np.float32)
    _close(name, port.get(name).batch(xs, ys, device="cpu"),
           dist.batch(xs, ys))
    _close(name, port.get(name).matrix(xs[:5], ys[:7], device="cpu"),
           dist.matrix(xs[:5], ys[:7]))


@pytest.mark.parametrize("name", ALIGN)
def test_ragged_batch_and_matrix_match_reference(name):
    """Per-row lengths over padded rows (padding filled with junk, which
    must never leak into a result)."""
    rng = np.random.default_rng(77)
    B, L = 12, 14
    lx = rng.integers(1, L + 1, B)
    ly = rng.integers(1, L + 1, B)
    if ref.get(name).string:
        xs = rng.integers(0, 6, size=(B, L))
        ys = rng.integers(0, 6, size=(B, L))
    else:
        xs = rng.normal(size=(B, L, 2)).astype(np.float32)
        ys = rng.normal(size=(B, L, 2)).astype(np.float32)
    _close(name, port.get(name).batch(xs, ys, lx, ly, device="cpu"),
           ref.get(name).batch(xs, ys, lx, ly))
    _close(name, port.get(name).matrix(xs[:4], ys[:6], lx[:4], ly[:6],
                                       device="cpu"),
           ref.get(name).matrix(xs[:4], ys[:6], lx[:4], ly[:6]))


@pytest.mark.parametrize("name", ["erp", "dtw"])
def test_big_overflow_matches_reference(name):
    xs = np.full((4, 24, 1), 1e25, np.float32)
    got = port.get(name).batch(xs, -xs, device="cpu").numpy()
    want = np.asarray(ref.get(name).batch(xs, -xs))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_tensor_inputs_keep_their_device():
    x = torch.zeros((3, 5, 2))
    out = port.get("dtw").batch(x, x + 1.0)
    assert out.device == x.device and out.shape == (3,)


def test_unkernelled_distance_runs_its_batch_on_the_counter_device():
    """A third-party distance has no kernel: under the ``kernel`` backend
    its registry ``batch`` runs on the counter's device (never a silent
    move to the host numpy wavefront), with the reference's values and
    counts."""
    import dataclasses
    from repro.core.counter import CountedDistance as RefCounted
    from repro_torch.core.counter import CountedDistance
    lev = port.get("levenshtein")
    seen = []

    def batch(xs, ys, lx=None, ly=None, device=None):
        seen.append((type(ys), getattr(ys, "device", None)))
        return lev.batch(xs, ys, lx, ly, device=device)

    mine = dataclasses.replace(lev, name="lev_third_party", batch=batch)
    rng = np.random.default_rng(9)
    data = rng.integers(0, 5, size=(12, 8)).astype(np.int32)
    q = rng.integers(0, 5, size=(6,)).astype(np.int32)
    c = CountedDistance(mine, data, backend="kernel", device="cpu")
    r = RefCounted(ref.get("levenshtein"), data, backend="numpy")
    idxs = [0, 3, 5, 11]
    np.testing.assert_array_equal(c.eval(q, idxs), r.eval(q, idxs))
    assert seen and all(t is torch.Tensor and d == torch.device("cpu")
                        for t, d in seen)
    assert (c.count, c.dispatches) == (r.count, r.dispatches) == (4, 1)


@pytest.mark.parametrize("name", ["levenshtein", "erp"])
def test_consistency_holds_like_reference(name):
    """Paper Def. 1 on short random pairs, checked through the port's
    pair/matrix on the CPU, agreeing with the reference's checker."""
    from repro.core.consistency import check_consistency as ref_check
    rng = np.random.default_rng(5)
    for _ in range(3):
        q, x = _rand_pair(name, 5, 4, rng)
        assert check_consistency(port.get(name), q, x, device="cpu")
        assert ref_check(ref.get(name), q, x)
