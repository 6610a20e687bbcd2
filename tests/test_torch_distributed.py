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
from repro_torch.kernels import registry as port_registry  # noqa: E402
from repro_torch.kernels import ring_filter  # noqa: E402
from repro_torch.launch.elastic import ElasticIndex  # noqa: E402
from repro_torch.serve import FleetSnapshotManager, snapshot  # noqa: E402

import ring_cases  # noqa: E402

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


#: the stats key the port adds to the reference's: the slots the ring
#: filter visited
SLOT_KEYS = ("filter_slots",)


def _assert_stats(got, want, flat, Q, prefix=""):
    """Every key of the reference's stats equal, and the port's slot
    counter exact: ``Q`` times the pairs."""
    assert {k: got[k] for k in want} == want
    assert set(got) == set(want) | {prefix + k for k in SLOT_KEYS}
    assert got[prefix + "filter_slots"] == Q * len(flat.mem_id)


def _assert_flat_equal(got, want, rtol):
    """The port's pairs are the reference's padded lists' valid entries
    in their order (read off by ``ring_cases.csr``); the other arrays
    equal."""
    pv, ids, md = ring_cases.csr(want.members, want.member_dist)
    np.testing.assert_array_equal(got.mem_pivot, pv)
    np.testing.assert_array_equal(got.mem_id, ids)
    np.testing.assert_array_equal(got.pivot_ids, want.pivot_ids)
    np.testing.assert_array_equal(got.pivots, want.pivots)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.n_pivots == want.n_pivots and got.dist_name == want.dist_name
    if rtol:
        np.testing.assert_allclose(got.mem_dist, md, rtol=rtol)
        np.testing.assert_allclose(got.pivot_radius, want.pivot_radius,
                                   rtol=rtol)
    else:
        np.testing.assert_array_equal(got.mem_dist, md)
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
    _assert_stats(stats, want_stats, got_flat, len(qs))
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
    _assert_stats(stats, want_stats, got_flat, len(qs))
    assert stats["capacity"] > 8 and stats["member_evals"] > 8
    assert dist_mod.final_capacity(8, 9) == 16
    assert dist_mod.final_capacity(8, 8) == 8


def _toy_flat(mod):
    """A 1-pivot FlatNet whose FIRST member slot needs an exact eval at
    eps=2.5 (the reference's positional-validity regression case)."""
    data = np.asarray([[3.0, 0.0], [4.0, 0.0], [1.0, 0.0]], np.float32)
    ids = np.asarray([1, 0, 2], np.int64)
    ds = np.asarray([1.0, 0.0, 2.0], np.float32)
    lists = (dict(mem_pivot=np.zeros(3, np.int64), mem_id=ids, mem_dist=ds)
             if mod is dist_mod else
             dict(members=ids[None], member_dist=ds[None]))
    return mod.FlatNet(
        pivots=data[[0]], pivot_radius=np.asarray([2.0], np.float32),
        **lists, data=data, n_pivots=1, dist_name="euclidean",
        pivot_ids=np.asarray([0], np.int64))


def test_survivor_zero_is_a_real_row():
    qs = np.zeros((1, 2), np.float32)
    hits, stats = dist_mod.device_range_query(_toy_flat(dist_mod), qs, 2.5,
                                              capacity=16, device="cpu")
    want_hits, want_stats = ref_dist.device_range_query(
        _toy_flat(ref_dist), qs, 2.5, capacity=16)
    _assert_stats(stats, want_stats, _toy_flat(dist_mod), len(qs))
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
        alive = [f for i, f in enumerate(got_flats) if i not in dead]
        merged = dist_mod.merge_flats(alive)[0]
        for i, (g, w) in enumerate(zip(gst, wst)):
            if w is None:
                assert g is None
            elif w.get("merged"):
                _assert_stats(g, w, merged, len(qs), prefix="fleet_")
            else:
                _assert_stats(g, w, got_flats[i], len(qs))
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
    _assert_stats(st, want_st, got, len(qs))
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


def _port_flat(name, data, eps_prime=1.0):
    """A port-only flat net (no reference build)."""
    return dist_mod.flatten_net(ReferenceNet(
        get(name), data, eps_prime=eps_prime, tight_bounds=True,
        counter=CountedDistance(get(name), data, device="cpu")).build())


@pytest.mark.parametrize("change", ["merged", "appended", "removed",
                                    "restored"])
def test_device_arrays_hold_the_valid_pairs_in_order(change, tmp_path):
    """The CSR pairs ``device_arrays`` uploads are the reference's padded
    lists' valid entries, pivot-major and each list in its stored order,
    after a merge, an ``append`` (new ids at the end of their lists) and a
    ``remove`` (the ids gone, the rest in their order); a fleet snapshot,
    saved and restored, uploads the pairs of the fleet it was taken
    from."""
    cpu = torch.device("cpu")
    data = proteins(200, seed=11)
    new = np.arange(180, 200)
    gone = [3, 77, 150, 151]
    if change == "restored":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            fleet = ElasticIndex("levenshtein", data[:180], ["a", "b", "c"],
                                 device="cpu")
        snap = FleetSnapshotManager(tmp_path)
        snap.save(fleet, block=True)
        back = snap.restore(device="cpu")
        was = dist_mod.merge_flats([fleet.shards[w].flat
                                    for w in fleet.workers])[0]
        want = tuple(was.device_arrays(cpu)[k].numpy()
                     for k in ("mem_pivot", "mem_id", "mem_dist"))
        flat = dist_mod.merge_flats([back.shards[w].flat
                                     for w in back.workers])[0]
    else:
        nets = [_nets("levenshtein", data[ids])
                for ids in np.array_split(np.arange(180), 3)]
        flat = dist_mod.merge_flats([dist_mod.flatten_net(port)
                                     for port, _ in nets])[0]
        ref = ref_dist.merge_flats([ref_dist.flatten_net(refn)
                                    for _, refn in nets])[0]
        flat.device_arrays(cpu)
        if change == "appended":
            rows = [int(k) % flat.n_pivots for k in range(len(new))]
            for f in (flat, ref):
                f.append(rows, new, np.linspace(0.0, 5.0, len(new)),
                         new_data=data[180:])
        elif change == "removed":
            flat.remove(gone)
            ref.remove(gone)
        assert (flat._on_device is None) == (change != "merged")
        want = ring_cases.csr(ref.members, ref.member_dist)
    arrs = flat.device_arrays(cpu)
    pv, ids, md = want
    assert arrs["mem_pivot"].dtype == arrs["mem_id"].dtype == torch.int32
    assert arrs["mem_dist"].dtype == arrs["pradius"].dtype == torch.float32
    np.testing.assert_array_equal(arrs["mem_pivot"].numpy(), pv)
    np.testing.assert_array_equal(arrs["mem_id"].numpy(), ids)
    np.testing.assert_array_equal(arrs["mem_dist"].numpy(), md)
    got = set(arrs["mem_id"].tolist())
    assert len(got) == len(ids) == len(flat.data) - len(gone) * (
        change == "removed")
    if change == "appended":
        assert set(new.tolist()) <= got
    if change == "removed":
        assert not got & set(gone)


@pytest.mark.parametrize("name", ring_cases.CASES)
def test_ring_filter_equals_the_padded_broadcast(name):
    """The plain ring filter over the CSR pairs gives the padded (Q, P, M)
    broadcast's hit mask and its survivors in ``nonzero``'s order, with
    their rows; ``ties`` puts ``eps`` exactly on each of the four
    bounds."""
    dp, pr, members, md, eps = ring_cases.case(name)
    Q, N = len(dp), 300
    t = torch.as_tensor
    want_hits, want_q, want_w = ring_cases.padded(t(dp), t(pr), t(members),
                                                  t(md), eps, N)
    pv, ids, mdist = ring_cases.csr(members, md)
    hits = torch.zeros((Q, N), dtype=torch.bool)
    v = ring_filter.ring_filter(t(dp), t(pr), t(pv), t(ids), t(mdist), eps,
                                hits)
    n = int(v.n_need)
    rng = np.random.default_rng(1)
    qs = t(rng.normal(size=(Q, 5, 2)).astype(np.float32))
    q_lens = t((np.arange(Q) % 5 + 1).astype(np.int32))
    data = torch.arange(N * 5, dtype=torch.int32).reshape(N, 5)
    rows = ring_filter.survivor_rows(v, n, qs, q_lens, data)
    assert torch.equal(hits, want_hits)
    assert n == len(want_q) == len(rows.q_of)
    assert torch.equal(rows.q_of, want_q) and torch.equal(rows.w_of, want_w)
    assert torch.equal(rows.q_len, q_lens[want_q])
    assert torch.equal(rows.xs, qs[want_q])
    assert torch.equal(rows.ys, data[want_w])
    if name == "none":
        assert n == 0 and not hits.any()
    if name == "all":
        assert n == Q * len(ids) and not hits.any()
    if name in ("random", "ties"):
        assert 0 < n < Q * len(ids) and hits.any()
    if name == "ties":
        at = ring_cases.boundary_slots(dp, pr, members, md, eps)
        assert min(at.values()) > 0, at


def _queries_of(name, data, Q, rng):
    qs = data[rng.integers(0, len(data), Q)].copy()
    if qs.dtype.kind in "iu":
        flips = rng.random(qs.shape) < 0.1
        qs[flips] = rng.integers(0, int(data.max()) + 1, flips.sum())
    else:
        qs += rng.normal(scale=0.1, size=qs.shape).astype(qs.dtype)
    return qs


@pytest.mark.parametrize("name", ["dtw", "erp", "frechet", "levenshtein",
                                  "euclidean", "hamming"])
def test_device_range_query_every_distance(name):
    """The one-shot query through the plain ring filter, for every
    distance: hits and every stats key of the reference's query over the
    same flat net (``capacity`` 16 forces its doubling), and, for the
    metrics, the brute-force oracle's hits.  DTW is no metric, so its net
    is Frechet's, relinked with DTW's pivot-member distances."""
    gen = proteins if name in ("levenshtein", "hamming") else trajectories
    data = gen(80, seed=4)
    flat = _port_flat("frechet" if name == "dtw" else name, data)
    if name == "dtw":
        md = port_registry.get("dtw").batch(
            data[flat.pivot_ids[flat.mem_pivot]], data[flat.mem_id],
            device="cpu").dist.numpy().astype(np.float32)
        radius = np.zeros(flat.n_pivots, np.float32)
        np.maximum.at(radius, flat.mem_pivot, md)
        flat = dist_mod.FlatNet(
            pivots=flat.pivots, pivot_radius=radius,
            mem_pivot=flat.mem_pivot, mem_id=flat.mem_id, mem_dist=md,
            data=flat.data, n_pivots=flat.n_pivots, dist_name="dtw",
            pivot_ids=flat.pivot_ids)
    rng = np.random.default_rng(2)
    qs = _queries_of(name, data, 5, rng)
    brute = dist_mod.host_reference_hits(flat, qs, np.inf)
    assert brute.all()
    ds = np.sort(np.asarray(port_registry.get(name).batch(
        np.repeat(qs, len(data), axis=0), np.tile(data, (5,) + (1,) * (
            data.ndim - 1)), device="cpu").dist))
    eps = float(ds[len(ds) // 20])      # about 5 % of the pairs hit
    hits, stats = dist_mod.device_range_query(flat, qs, eps, capacity=16,
                                              device="cpu")
    members, member_dist = snapshot.padded_lists(flat)
    want_flat = ref_dist.FlatNet(
        pivots=flat.pivots, pivot_radius=flat.pivot_radius,
        members=members, member_dist=member_dist, data=flat.data,
        n_pivots=flat.n_pivots, dist_name=name, pivot_ids=flat.pivot_ids)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want_hits, want_stats = ref_dist.device_range_query(
            want_flat, qs, eps, capacity=16)
    np.testing.assert_array_equal(hits, np.asarray(want_hits))
    _assert_stats(stats, want_stats, flat, len(qs))
    assert stats["capacity"] > 16 and stats["member_evals"] > 16
    if name != "dtw":
        np.testing.assert_array_equal(
            hits, dist_mod.host_reference_hits(flat, qs, eps))
    assert hits.any()


@pytest.mark.parametrize("frac", ring_cases.FRACTIONS)
@pytest.mark.parametrize("bound", ["dp+mdist", "|dp-mdist|"])
@pytest.mark.parametrize("name", ["levenshtein", "erp"])
def test_eps_no_f32_holds(flats, name, bound, frac):
    """``eps`` an f64 between two f32 values, beside a real pair's
    ``dp + mdist`` or ``|dp - mdist|`` in a list with no whole-list
    verdict: the plain filter rounds ``eps`` to the nearest f32, as the
    reference's comparison does, so hits and every stats key equal the
    reference's over the same flat net, and the pair's verdict after pass
    1 is the f32 one."""
    data, flat, _, _, _ = flats[name]
    rng = np.random.default_rng(12)
    qs = _queries_of(name, data, 6, rng)
    arrs = flat.device_arrays(torch.device("cpu"))
    P = flat.n_pivots
    qs_t = dist_mod._operand_of(name)(qs).contiguous()
    q_lens = torch.full((len(qs),), qs.shape[1], dtype=torch.int32)
    piv = arrs["pivots"]
    dp = port_registry.get(name).device_call(
        qs_t.repeat_interleave(P, dim=0),
        piv.repeat((len(qs),) + (1,) * (piv.ndim - 1)),
        lx=q_lens.repeat_interleave(P)).dist.reshape(len(qs), P)
    pv, ids, md = (arrs[k].numpy() for k in ("mem_pivot", "mem_id",
                                             "mem_dist"))
    q, j, hi, lo = ring_cases.undecided_pair(
        dp.numpy(), flat.pivot_radius, pv, md, rng)
    at = hi if bound == "dp+mdist" else lo
    eps = ring_cases.between(at, frac)
    hits1 = torch.zeros((len(qs), len(flat.data)), dtype=torch.bool)
    v = ring_filter.ring_filter(dp.contiguous(), arrs["pradius"],
                                arrs["mem_pivot"], arrs["mem_id"],
                                arrs["mem_dist"], eps, hits1)
    e32 = np.float32(eps)
    slot = q * len(ids) + j
    if hi <= e32:                           # accepted free in f32
        assert hits1[q, ids[j]]
    assert bool((v.order == slot).any()) == bool(lo <= e32 < hi)
    hits, stats = dist_mod.device_range_query(flat, qs, eps, device="cpu")
    members, member_dist = snapshot.padded_lists(flat)
    want_flat = ref_dist.FlatNet(
        pivots=flat.pivots, pivot_radius=flat.pivot_radius,
        members=members, member_dist=member_dist, data=flat.data,
        n_pivots=flat.n_pivots, dist_name=name, pivot_ids=flat.pivot_ids)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want_hits, want_stats = ref_dist.device_range_query(want_flat, qs,
                                                            eps)
    np.testing.assert_array_equal(hits, np.asarray(want_hits))
    _assert_stats(stats, want_stats, flat, len(qs))
