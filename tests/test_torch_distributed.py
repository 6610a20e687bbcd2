"""The port's flattened-net device query against the JAX reference, on the
CPU.

The same seeded windows go into both packages; the port's query runs its
torch ops and the wavefront kernel's plain version on ``device="cpu"``,
the reference's ``device_range_query`` its ``lax.scan`` twin of the Pallas
kernel (the process default is pinned to ``scan`` for each test and
restored after).  Levenshtein distances are exact small integers on both
sides, so flattened arrays, hit masks and every stats key must be
identical; ERP link distances are f32 sums whose order may differ
(``rtol = 1e-6``), and its hit masks and stats must still be identical.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as ref_dist  # noqa: E402
from repro.core.refnet import ReferenceNet as RefNet  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core.counter import CountedDistance  # noqa: E402
from repro_torch.core.refnet import ReferenceNet  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    protein_sequences, proteins, trajectories)
from repro_torch.distances import get  # noqa: E402

GEN = {"levenshtein": proteins, "erp": trajectories}


@pytest.fixture(autouse=True)
def scan_exec():
    prev = ref_registry.set_default_exec("scan")
    yield
    ref_registry.set_default_exec(prev)


def _nets(name, data, eps_prime=1.0):
    """The same sequentially built reference net in both packages."""
    port = ReferenceNet(get(name), data, eps_prime=eps_prime,
                        tight_bounds=True,
                        counter=CountedDistance(get(name), data,
                                                device="cpu")).build()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        refn = RefNet(name, data, eps_prime=eps_prime,
                      tight_bounds=True).build()
    return port, refn


@pytest.fixture(scope="module")
def flats():
    out = {}
    for name, n, ep in (("levenshtein", 150, 1.0), ("erp", 120, 0.5)):
        data = GEN[name](n, seed=8)
        port, refn = _nets(name, data, ep)
        out[name] = (data, dist_mod.flatten_net(port),
                     ref_dist.flatten_net(refn), port, refn)
    return out


def _assert_flat_equal(got, want, rtol):
    np.testing.assert_array_equal(got.members, want.members)
    np.testing.assert_array_equal(got.pivot_ids, want.pivot_ids)
    np.testing.assert_array_equal(got.pivots, want.pivots)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.n_pivots == want.n_pivots and got.dist_name == want.dist_name
    if rtol:
        np.testing.assert_allclose(got.member_dist, want.member_dist,
                                   rtol=rtol)
        np.testing.assert_allclose(got.pivot_radius, want.pivot_radius,
                                   rtol=rtol)
    else:
        np.testing.assert_array_equal(got.member_dist, want.member_dist)
        np.testing.assert_array_equal(got.pivot_radius, want.pivot_radius)
    assert (got.envelopes is None) == (want.envelopes is None)
    if got.envelopes is not None:
        for k in ("lo", "hi", "mass", "cum", "lens"):
            np.testing.assert_allclose(getattr(got.envelopes, k),
                                       getattr(want.envelopes, k),
                                       rtol=1e-6)


@pytest.mark.parametrize("name", ["levenshtein", "erp"])
def test_flatten_net_matches_reference(flats, name):
    data, got, want, port, refn = flats[name]
    _assert_flat_equal(got, want, 1e-6 if name == "erp" else 0)
    assert port.counter.build_count == refn.counter.build_count
    assert got.n_pivots < len(data)


@pytest.mark.parametrize("name,eps,lb,ragged", [
    ("levenshtein", 2.0, "off", False),
    ("levenshtein", 3.0, "off", True),
    ("erp", 1.0, "off", False),
    ("erp", 1.0, "envelope", False),
    ("erp", 2.0, "envelope", True),
])
def test_device_range_query_matches_reference(flats, name, eps, lb, ragged):
    data, got_flat, ref_flat, _, _ = flats[name]
    rng = np.random.default_rng(3)
    qs = data[rng.integers(0, len(data), 6)].copy()
    q_lens = None
    if ragged:   # per-query lengths inside one padded batch
        q_lens = rng.integers(12, qs.shape[1] + 1, 6).astype(np.int32)
        q_lens[0] = qs.shape[1]
    hits, stats = dist_mod.device_range_query(
        got_flat, qs, eps, q_lens=q_lens, lb_cascade=lb, device="cpu")
    want_hits, want_stats = ref_dist.device_range_query(
        ref_flat, qs, eps, q_lens=q_lens, lb_cascade=lb)
    np.testing.assert_array_equal(hits, np.asarray(want_hits))
    assert stats == want_stats
    if not ragged:
        np.testing.assert_array_equal(
            hits, dist_mod.host_reference_hits(got_flat, qs, eps))
    if lb == "envelope":
        assert stats["lb_rows"] > 0
    assert hits.any()


def test_forced_overflow_reports_the_reference_capacity(flats):
    data, got_flat, ref_flat, _, _ = flats["levenshtein"]
    qs = data[:3]
    hits, stats = dist_mod.device_range_query(got_flat, qs, 6.0,
                                              capacity=8, device="cpu")
    want_hits, want_stats = ref_dist.device_range_query(ref_flat, qs, 6.0,
                                                        capacity=8)
    np.testing.assert_array_equal(hits, np.asarray(want_hits))
    assert stats == want_stats
    assert stats["capacity"] > 8 and stats["member_evals"] > 8
    assert dist_mod.final_capacity(8, 9) == 16
    assert dist_mod.final_capacity(8, 8) == 8


def _toy_flat(mod):
    """A 1-pivot FlatNet whose FIRST member slot needs an exact eval at
    eps=2.5 (the reference's positional-validity regression case)."""
    data = np.asarray([[3.0, 0.0], [4.0, 0.0], [1.0, 0.0]], np.float32)
    return mod.FlatNet(
        pivots=data[[0]], pivot_radius=np.asarray([2.0], np.float32),
        members=np.asarray([[1, 0, 2]], np.int64),
        member_dist=np.asarray([[1.0, 0.0, 2.0]], np.float32),
        data=data, n_pivots=1, dist_name="euclidean",
        pivot_ids=np.asarray([0], np.int64))


def test_survivor_zero_is_a_real_row():
    qs = np.zeros((1, 2), np.float32)
    hits, stats = dist_mod.device_range_query(_toy_flat(dist_mod), qs, 2.5,
                                              capacity=16, device="cpu")
    want_hits, want_stats = ref_dist.device_range_query(
        _toy_flat(ref_dist), qs, 2.5, capacity=16)
    assert stats == want_stats
    assert stats["member_evals"] == 2
    np.testing.assert_array_equal(hits, [[False, False, True]])
    np.testing.assert_array_equal(hits, np.asarray(want_hits))


def _shards(mod, name, data, parts):
    flats = []
    for ids in parts:
        port, refn = _nets(name, data[ids])
        flats.append(mod.flatten_net(port if mod is dist_mod else refn))
    return flats


@pytest.mark.parametrize("stacked", [True, False])
def test_merge_flats_and_fleet_range_query_match_reference(stacked):
    data = proteins(180, seed=11)
    parts = np.array_split(np.arange(len(data)), 3)
    got_flats = _shards(dist_mod, "levenshtein", data, parts)
    ref_flats = _shards(ref_dist, "levenshtein", data, parts)
    (got_m, got_off), (want_m, want_off) = (
        dist_mod.merge_flats(got_flats), ref_dist.merge_flats(ref_flats))
    assert got_off == want_off
    _assert_flat_equal(got_m, want_m, 0)
    qs = data[[2, 70, 150, 171]]
    for dead in ((), (1,)):
        got, gst = dist_mod.fleet_range_query(
            got_flats, qs, 2.0, dead=dead, stacked=stacked, device="cpu")
        want, wst = ref_dist.fleet_range_query(
            ref_flats, qs, 2.0, dead=dead, stacked=stacked)
        assert gst == wst
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, np.asarray(w))
        assert got[1] is None if dead else got[1].any()


def test_flatnet_append_and_remove_match_reference_and_refresh_device():
    data = proteins(170, seed=14)
    base, new = data[:150], data[150:]
    port, refn = _nets("levenshtein", base)
    got, want = dist_mod.flatten_net(port), ref_dist.flatten_net(refn)
    qs = data[[3, 152, 160]]
    dist_mod.device_range_query(got, qs, 2.0, device="cpu")
    assert got._on_device is not None   # uploaded once, kept
    batch = get("levenshtein").batch
    rows, ids, dists = [], [], []
    for k, w in enumerate(new):
        ds = batch(np.repeat(w[None], got.n_pivots, 0), got.pivots,
                   device="cpu").numpy()
        rows.append(int(np.argmin(ds)))
        ids.append(150 + k)
        dists.append(float(ds.min()))
    got.append(rows, ids, dists, new_data=new)
    want.append(rows, ids, dists, new_data=new)
    assert got._on_device is None       # the stale copy is dropped
    _assert_flat_equal(got, want, 0)
    hits, st = dist_mod.device_range_query(got, qs, 2.0, device="cpu")
    np.testing.assert_array_equal(
        hits, dist_mod.host_reference_hits(got, qs, 2.0))
    assert hits[:, 150:].any()          # the appended windows answer
    gone = [152, 160, 5]
    got.remove(gone)
    want.remove(gone)
    _assert_flat_equal(got, want, 0)
    hits, st = dist_mod.device_range_query(got, qs, 2.0, device="cpu")
    want_hits, want_st = ref_dist.device_range_query(want, qs, 2.0)
    np.testing.assert_array_equal(hits, np.asarray(want_hits))
    assert st == want_st
    assert not hits[:, gone].any()


def test_matcher_flat_net_matches_reference():
    import repro.retrieval as ref
    from repro_torch.retrieval import RetrievalConfig, Retriever
    seqs = protein_sequences(3, 120, seed=2)
    kw = dict(lam=16, lambda0=1, tight_bounds=True, num_max=5)
    got = Retriever.build(RetrievalConfig("levenshtein", device="cpu",
                                          **kw), seqs).matcher.flat_net()
    want = ref.Retriever.build(ref.RetrievalConfig(
        "levenshtein", **kw), seqs).matcher.flat_net()
    assert isinstance(got, dist_mod.FlatNet)
    _assert_flat_equal(got, want, 0)


def test_batch_dist_shim_warns_and_delegates():
    xs = proteins(4, seed=1)
    with pytest.warns(DeprecationWarning, match="registry"):
        d = dist_mod._batch_dist("levenshtein", xs, xs[::-1], device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_dist._batch_dist("levenshtein", xs, xs[::-1])
    np.testing.assert_array_equal(d.numpy(), np.asarray(want))
