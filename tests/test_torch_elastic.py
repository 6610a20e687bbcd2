"""The port's elastic fleet against the JAX reference, on the CPU.

Rendezvous assignment and moved fractions are pure functions of the ids
and worker names, so they must be identical.  Fleets are built over the
same seeded windows in both packages: the port on its ``kernel`` backend
(the wavefront kernel's plain version for ``device="cpu"``), the
reference on ``backend="pallas"`` in its ``lax.scan`` lane.  Levenshtein
distances are exact small integers, so build counts, hit sets, the
one-shot query's stats and ``device_stats`` must be identical; so must
they on ERP trajectories, with and without the envelope cascade.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.retrieval as ref  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro.launch import elastic as ref_elastic  # noqa: E402
from repro_torch.data.synthetic import proteins, trajectories  # noqa: E402
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

WORKERS = ["w0", "w1", "w2", "w3"]
REF = dict(backend="pallas", kernel_exec="scan")


@pytest.fixture(autouse=True)
def scan_exec():
    prev = ref_registry.set_default_exec("scan")
    yield
    ref_registry.set_default_exec(prev)


def _mutate(data, n, seed, rate=0.1):
    """``benchmarks/common.mutate_queries``."""
    rng = np.random.default_rng(seed)
    qs = data[rng.integers(0, len(data), n)].copy()
    if data.dtype.kind in "iu":
        flips = rng.random(qs.shape) < rate
        qs[flips] = rng.integers(0, int(data.max()) + 1, flips.sum())
    else:
        qs += rng.normal(scale=rate * np.std(data),
                         size=qs.shape).astype(qs.dtype)
    return qs


def _build(name, data, workers=WORKERS, **kw):
    port = Retriever.build(RetrievalConfig(
        name, execution="fleet", workers=workers, tight_bounds=True,
        device="cpu", **kw), data)
    refr = ref.Retriever.build(ref.RetrievalConfig(
        name, execution="fleet", workers=workers, tight_bounds=True,
        **REF, **kw), data)
    return port, refr


@pytest.fixture(scope="module")
def lev():
    prev = ref_registry.set_default_exec("scan")
    try:
        data = proteins(240, seed=0)
        return data, _mutate(data, 6, seed=3), *_build("levenshtein", data)
    finally:
        ref_registry.set_default_exec(prev)


@pytest.mark.parametrize("before,after", [
    (4, 5), (5, 4), (3, 1), (2, 6)])
def test_assign_and_moved_fraction_match_reference(before, after):
    ids = range(700)
    wb = [f"w{i}" for i in range(before)]
    wa = [f"w{i}" for i in range(after)]
    a, b = elastic.assign(ids, wb), elastic.assign(ids, wa)
    assert a == ref_elastic.assign(ids, wb)
    assert b == ref_elastic.assign(ids, wa)
    frac = elastic.moved_fraction(a, b)
    assert frac == ref_elastic.moved_fraction(a, b)
    assert 0 < frac < 1


def test_fleet_build_counts_match_reference(lev):
    data, _, port, refr = lev
    assert port.eval_stats() == refr.eval_stats()
    got, want = port.elastic().index, refr.elastic().index
    for w in WORKERS:
        np.testing.assert_array_equal(got.shards[w].gids,
                                      want.shards[w].gids)
        assert got.shards[w].flat.n_pivots == want.shards[w].flat.n_pivots
    assert got.backend == "kernel" and got.device == torch.device("cpu")


@pytest.mark.parametrize("via", ["host", "batched", "fleet-rounds",
                                 "fleet-oneshot"])
def test_fleet_queries_match_reference(lev, via):
    data, qs, port, refr = lev
    got = port.batch(qs).via(via).range(2.0)
    want = refr.batch(qs).via(via).range(2.0)
    assert got.hits == want.hits
    assert got.stats == want.stats
    assert got.hits == refr.batch(qs).via("host").range(2.0).hits
    single = port.query(qs[0]).via(via).range(2.0)
    assert single.hits == got.hits[0]
    assert single.stats == refr.query(qs[0]).via(via).range(2.0).stats
    assert port.elastic().device_stats == refr.elastic().device_stats


def test_round_dispatches_carry_shard_provenance(lev):
    """A merged fleet round is one packed dispatch whose rows carry their
    shard: the per-shard row totals equal the reference's."""
    from repro.kernels import dispatch as ref_dispatch
    from repro_torch.kernels import dispatch
    data, qs, port, refr = lev
    dispatch.STATS.reset()
    ref_dispatch.STATS.reset()
    port.batch(qs).via("fleet-rounds").range(2.0)
    refr.batch(qs).via("fleet-rounds").range(2.0)
    assert dispatch.STATS.shard_rows == ref_dispatch.STATS.shard_rows
    assert sorted(dispatch.STATS.shard_rows) == [0, 1, 2, 3]
    assert dispatch.STATS.dispatches == ref_dispatch.STATS.dispatches
    assert dict(dispatch.STATS.last_meta.shard_rows) \
        == dict(ref_dispatch.STATS.last_meta.shard_rows)


@pytest.mark.parametrize("via", ["host", "fleet-rounds", "fleet-oneshot"])
def test_dead_worker_gives_the_survivors_union(lev, via):
    data, qs, port, refr = lev
    got = port.batch(qs).via(via).dead("w1").range(2.0)
    want = refr.batch(qs).via(via).dead("w1").range(2.0)
    assert got.hits == want.hits and got.stats == want.stats
    full = port.batch(qs).via("host").range(2.0).hits
    lost = set(port.elastic().index.assignment["w1"])
    assert got.hits == [[h for h in hs if h not in lost] for hs in full]
    assert any(h in lost for hs in full for h in hs)  # the mask bites
    handle = port.elastic().mark_dead("w1")
    assert handle.dead == ["w1"]
    assert port.batch(qs).via(via).range(2.0).hits == got.hits
    handle.revive("w1")
    assert port.batch(qs).via(via).range(2.0).hits == full


def test_resize_round_trip_matches_reference():
    data = proteins(200, seed=1)
    qs = _mutate(data, 5, seed=4)
    port, refr = _build("levenshtein", data)
    before = port.batch(qs).range(2.0).hits
    assert refr.batch(qs).range(2.0).hits == before
    for workers in (WORKERS + ["w4"], WORKERS):
        frac = port.elastic().resize(workers)
        assert frac == refr.elastic().resize(workers)
        assert 0 < frac < 0.5
        assert port.eval_stats() == refr.eval_stats()
        assert port.elastic().workers == workers
        for w in workers:
            np.testing.assert_array_equal(
                port.elastic().index.shards[w].gids,
                refr.elastic().index.shards[w].gids)
        for via in ("fleet-rounds", "fleet-oneshot"):
            got = port.batch(qs).via(via).range(2.0)
            want = refr.batch(qs).via(via).range(2.0)
            assert got.hits == want.hits == before
            assert got.stats == want.stats
    assert port.elastic().device_stats == refr.elastic().device_stats


def test_erp_fleet_envelope_cascade_matches_reference():
    data = trajectories(200, seed=0)
    qs = _mutate(data, 5, seed=3)
    port, refr = _build("erp", data)
    for tier in ("off", "envelope"):
        for via in ("fleet-rounds", "fleet-oneshot"):
            got = port.batch(qs).via(via).lb(tier).range(1.0)
            want = refr.batch(qs).via(via).lb(tier).range(1.0)
            assert got.hits == want.hits and got.stats == want.stats
            assert got.hits == port.batch(qs).via("host").range(1.0).hits
    stats = port.elastic().device_stats
    assert stats == refr.elastic().device_stats
    assert stats["lb_rows"] > 0 and stats["lb_pruned"] > 0


def test_numpy_backend_fleet_counts_equal_kernel_backend(lev):
    data, qs, port, _ = lev
    host = Retriever.build(RetrievalConfig(
        "levenshtein", execution="fleet", workers=WORKERS,
        tight_bounds=True, backend="numpy", device="cpu"), data)
    assert host.eval_stats()["build"] == port.eval_stats()["build"]
    for via in ("fleet-rounds", "fleet-oneshot"):
        a = host.batch(qs).via(via).range(2.0)
        b = port.batch(qs).via(via).range(2.0)
        assert a.hits == b.hits
        assert a.stats["device_evals"] == b.stats["device_evals"]


def test_fleet_facade_rules_match_reference():
    data = proteins(60, seed=2)
    cfg = RetrievalConfig("levenshtein", execution="fleet", workers=3,
                          device="cpu", fleet_mode="oneshot")
    assert cfg.workers == ("w0", "w1", "w2")
    assert RetrievalConfig.from_json(cfg.to_json()) == cfg
    assert cfg.to_dict()["workers"] == ["w0", "w1", "w2"]
    for bad in (dict(workers=None), dict(lam=8), dict(index="linear"),
                dict(lb_cascade="endpoint"), dict(fleet_mode="nope")):
        with pytest.raises(ValueError):
            cfg.replace(**bad)
    for bad in (dict(workers=2), dict(fleet_mode="oneshot"),
                dict(serve_max_inflight=0), dict(serve_admission="x")):
        with pytest.raises(ValueError):
            RetrievalConfig("levenshtein", device="cpu", **bad)
    r = Retriever.build(cfg, data)
    assert r.is_fleet and len(r.elastic().workers) == 3
    with pytest.raises(ValueError, match="envelope"):
        r.query(data[0]).lb("endpoint")
    with pytest.raises(ValueError, match="via"):
        r.query(data[0]).via("fleet")
    with pytest.raises(ValueError, match="range"):
        r.query(data[0]).nearest(2.0)
    with pytest.raises(ValueError, match="monotone"):
        r.reset_counter()
    assert r.query(data[0]).range(0.0).hits == [0]
    with pytest.warns(DeprecationWarning, match="ElasticIndex"):
        idx = elastic.ElasticIndex("levenshtein", data[:20], ["a", "b"],
                                   device="cpu")
    assert idx.backend == "kernel"
    assert idx.range_query(data[3], 0.0) == [3]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="fleet_mode"):
            elastic.ElasticIndex("levenshtein", data[:20], ["a"],
                                 fleet_mode="x", device="cpu")
