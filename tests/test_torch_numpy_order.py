"""The port's float distances bit-equal to the reference's numpy lane.

``repro``'s default lane is ``distances/np_backend.py`` (and
``distances/bounds.py`` for the envelope bounds): float32 sums over a last
axis in numpy's ``pairwise_sum`` order, ``np.cumsum`` left to right and a
correctly rounded ``np.sqrt``.  The port computes every float distance in
the same orders with the same roundings (``distances/_wavefront.py``:
``sum_last``, ``cumsum_seq``, ``sqrt_rn``), so the kernel's plain version,
the ``torch`` backend, the elementwise Euclidean, the ``lb:`` envelope
specs and the one-shot query's bound are held here with
``assert_array_equal``, not a tolerance.  Then a range query whose ε is
set exactly at a distance goes the same way in both packages, which the
facade cases check at every reference distance of their inputs.  The CUDA
kernel is held to the same lane on the card (``test_torch_kernel_gpu.py``
and ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.retrieval as ref  # noqa: E402
from repro.distances import bounds as ref_bounds  # noqa: E402
from repro.distances import np_backend  # noqa: E402
from repro_torch import distances  # noqa: E402
from repro_torch.core.distributed import _envelope_rows  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.distances._wavefront import (  # noqa: E402
    cumsum_seq, sqrt_rn, sum_last)
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

#: feature widths: left to right below 8, eight running sums up to 128,
#: numpy's split above
DS = [1, 2, 3, 7, 8, 9, 16, 60, 130, 300]
FLOAT = ["dtw", "erp", "frechet"]
MODE = {"dtw": "dtw", "erp": "erp", "frechet": "dfd"}
ENVELOPE = {"dtw": ref_bounds.lb_dtw_envelope,
            "erp": ref_bounds.lb_erp_envelope,
            "frechet": ref_bounds.lb_frechet_envelope}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: torch's threads would only contend with the run's
    other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("lengths", [range(1, 8), range(8, 129),
                                     [129, 200, 300, 517, 1000]])
def test_sum_last_is_numpys_pairwise_sum(lengths):
    rng = np.random.default_rng(1)
    for n in lengths:
        a = (rng.normal(size=(40, n))
             * rng.uniform(0.1, 100.0, size=(40, 1))).astype(np.float32)
        np.testing.assert_array_equal(sum_last(_t(a)).numpy(),
                                      np.sum(a, axis=-1), err_msg=str(n))
        # a 4-D last-axis reduction, as the numpy lane's squared costs
        b = a.reshape(5, 2, 4, n)
        np.testing.assert_array_equal(sum_last(_t(b)).numpy(),
                                      np.sum(b, axis=-1), err_msg=str(n))


def test_sqrt_rn_and_cumsum_seq_are_numpys():
    rng = np.random.default_rng(0)
    v = (rng.random(1 << 20) * rng.choice([1e-6, 1e-3, 1.0, 1e3, 1e6, 1e30],
                                          1 << 20)).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(_t(v)).numpy(), np.sqrt(v))
    assert sqrt_rn(_t(v)).dtype == torch.float32
    a = rng.normal(size=(2000, 60)).astype(np.float32)
    np.testing.assert_array_equal(cumsum_seq(_t(a)).numpy(),
                                  np.cumsum(a, axis=1))


def _ragged(rng, B, Lx, Ly, d):
    """Random-walk rows with seeded content past each row's lengths (the
    dispatch trims to the longest row; numpy reads the padded widths)."""
    xs = np.cumsum(rng.normal(scale=0.5, size=(B, Lx, d)), 1).astype(
        np.float32)
    ys = np.cumsum(rng.normal(scale=0.5, size=(B, Ly, d)), 1).astype(
        np.float32)
    lx = rng.integers(1, Lx + 1, B)
    ly = rng.integers(1, Ly + 1, B)
    lx[0], ly[0] = Lx, Ly
    return xs, ys, lx, ly


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", FLOAT)
def test_float_modes_bit_equal_to_numpy(name, d):
    """The kernel's plain version and the ``torch`` backend equal
    ``np_backend.batch_alignment``; an ε at each row's distance is a hit
    and one ulp below it a miss."""
    rng = np.random.default_rng(100 + d)
    xs, ys, lx, ly = _ragged(rng, 12, 9, 8, d)
    want = np_backend.batch_alignment(xs, ys, MODE[name], lx, ly)
    spec = registry.get(name)
    got = spec.batch(xs, ys, lx, ly, device="cpu")
    np.testing.assert_array_equal(got.dist.numpy(), want)
    np.testing.assert_array_equal(
        distances.get(name).batch(xs, ys, lx, ly, device="cpu").numpy(),
        want)
    at = spec.batch(xs, ys, lx, ly, eps=want, device="cpu")
    assert at.hit.all() and not at.pruned.any()
    np.testing.assert_array_equal(at.dist.numpy(), want)
    below = spec.batch(xs, ys, lx, ly, eps=np.nextafter(want, -np.inf),
                       device="cpu")
    assert not below.hit.any()


@pytest.mark.parametrize("L", [9, 300])
@pytest.mark.parametrize("d", [1, 8, 60])
def test_euclidean_bit_equal_to_numpy(d, L):
    """The ``kernel`` backend's elementwise spec and the ``torch`` backend
    against ``np_backend.batch_euclidean`` (the d-sum, masked, then the
    L-sum), ragged lengths up to 300."""
    rng = np.random.default_rng(7 * d + L)
    xs = rng.normal(size=(16, L, d)).astype(np.float32)
    ys = rng.normal(size=(16, L, d)).astype(np.float32)
    lx = rng.integers(1, L + 1, 16)
    lx[0] = L
    want = np_backend.batch_euclidean(xs, ys, lx)
    got = registry.get("euclidean").batch(xs, ys, lx, lx, device="cpu")
    np.testing.assert_array_equal(got.dist.numpy(), want)
    np.testing.assert_array_equal(
        distances.get("euclidean").batch(xs, ys, lx, device="cpu").numpy(),
        want)
    at = registry.get("euclidean").batch(xs, ys, lx, lx, eps=want,
                                         device="cpu")
    assert at.hit.all()
    below = registry.get("euclidean").batch(
        xs, ys, lx, lx, eps=np.nextafter(want, -np.inf), device="cpu")
    assert not below.hit.any()


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("name", FLOAT)
def test_envelope_bounds_bit_equal_to_numpy(name, d):
    """The ``lb:`` spec against ``bounds.lb_*_envelope`` (with and without
    the cached window envelopes the counter's host tier reads) and the one-shot
    query's bound against ``bounds.lb_envelope_rows`` (the candidates'
    boxes and masses from ``build_envelopes``)."""
    rng = np.random.default_rng(200 + d)
    xs, ys, lx, ly = _ragged(rng, 24, 13, 9, d)
    want = ENVELOPE[name](xs, ys, lx, ly)
    got = registry.get_envelope(name).batch(xs, ys, lx, ly, device="cpu")
    np.testing.assert_array_equal(got.dist.numpy(), want)
    # the counter's host tier reads the windows' cached envelopes
    env = ref_bounds.build_envelopes(ys, ly)
    np.testing.assert_array_equal(
        got.dist.numpy(), ENVELOPE[name](xs, ys, lx, ly, y_env=env))
    want = ref_bounds.lb_envelope_rows(name, xs, lx, env.lo, env.hi,
                                       env.mass)
    got = _envelope_rows(name, _t(xs), _t(lx), _t(env.lo), _t(env.hi),
                         _t(env.mass))
    np.testing.assert_array_equal(got.numpy(), want)


def _queries(data, n, seed):
    """``tests/test_torch_envelope.py``'s queries (``benchmarks/common``'s
    ``mutate_queries`` for float rows)."""
    rng = np.random.default_rng(seed)
    qs = data[rng.integers(0, len(data), n)].copy()
    return qs + rng.normal(scale=0.1 * np.std(data),
                           size=qs.shape).astype(qs.dtype)


@pytest.fixture(scope="module")
def traj():
    data = synthetic.trajectories(160, seed=0)
    return data, _queries(data, 4, seed=2)


def test_frechet_hit_at_a_last_bit_distance_matches_reference(traj):
    """Query 1 against window 23: numpy's Frechet distance is one ulp above
    6.4009246826171875, so at that ε the pair is a miss in both."""
    data, qs = traj
    port = Retriever.build(RetrievalConfig("frechet", index="linear",
                                           device="cpu"), data)
    refr = ref.Retriever.build(ref.RetrievalConfig("frechet",
                                                   index="linear"), data)
    eps = 6.4009246826171875
    d = np_backend.batch_alignment(qs[1:2], data[23:24], "dfd")[0]
    assert np.float32(eps) < d == np.nextafter(np.float32(eps), np.inf)
    got, want = port.batch(qs).range(eps), refr.batch(qs).range(eps)
    assert 23 not in got.hits[1]
    assert got.hits == want.hits and got.stats == want.stats


@pytest.mark.parametrize("name", FLOAT)
def test_range_at_every_reference_distance_matches_reference(traj, name):
    """ε set at each of the 640 reference distances (4 queries x 160
    windows), each query at its own 160: hit sets and ``stats`` of the
    port's default ``kernel`` backend equal ``repro``'s numpy lane."""
    data, qs = traj
    port = Retriever.build(RetrievalConfig(name, index="linear",
                                           device="cpu"), data)
    refr = ref.Retriever.build(ref.RetrievalConfig(name, index="linear"),
                               data)
    Q, N = len(qs), len(data)
    dist = np_backend.batch_alignment(
        np.repeat(qs, N, axis=0), np.tile(data, (Q, 1, 1)),
        MODE[name]).reshape(Q, N)
    for q in range(Q):
        for eps in dist[q]:
            got = port.batch(qs[q:q + 1]).range(float(eps))
            want = refr.batch(qs[q:q + 1]).range(float(eps))
            assert got.hits == want.hits, (q, float(eps))
            assert got.stats == want.stats, (q, float(eps))
            assert set(got.hits[0]) == set(np.flatnonzero(dist[q] <= eps))


def test_embedding_index_at_every_reference_distance_matches_reference():
    """The ``embedding`` index over 200 unit vectors of width 60 (the
    ``kernel`` backend's elementwise Euclidean) against ``repro``'s numpy
    lane: at ε = 2.4684624671936035, one ulp under numpy's distance of
    window 10 to the probe, window 10 misses in both; then ε set at each
    reference distance of that probe and of two more."""
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(200, 60))
    vecs = (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).astype(
        np.float32)
    probe = (vecs[7] + 0.3 * rng.normal(size=60)).astype(np.float32)
    probes = [probe] + [(vecs[i] + 0.3 * rng.normal(size=60)).astype(
        np.float32) for i in (50, 120)]
    kw = dict(index="embedding", eps_prime=0.02, num_max=5,
              tight_bounds=True)
    port = Retriever.build(RetrievalConfig("euclidean", device="cpu", **kw),
                           vecs)
    refr = ref.Retriever.build(ref.RetrievalConfig("euclidean", **kw), vecs)
    assert port.eval_stats() == refr.eval_stats()
    eps = 2.4684624671936035
    d10 = np_backend.batch_euclidean(probe[None], vecs[10:11])[0]
    assert d10 == np.nextafter(np.float32(eps), np.inf)
    got, want = port.query(probe).range(eps), refr.query(probe).range(eps)
    assert 10 not in got.hits
    assert got.hits == want.hits and got.stats == want.stats
    for p in probes:
        dist = np_backend.batch_euclidean(np.repeat(p[None], len(vecs), 0),
                                          vecs)
        for eps in dist:
            got = port.query(p).range(float(eps))
            want = refr.query(p).range(float(eps))
            assert got.hits == want.hits, float(eps)
            assert got.stats == want.stats, float(eps)
            assert set(got.hits) == set(np.flatnonzero(dist <= eps))
