"""The port's main path against the JAX reference, end to end on the CPU.

The quickstart flow (5-step subsequence matching, Levenshtein refnet), an
ERP window-level case, the endpoint LB cascade and the built-index
hand-over, with the same seeded numpy data given to both packages.  The
port runs ``device="cpu"``, where its ``kernel`` backend uses the wavefront
kernel's plain torch version; the reference runs its ``lax.scan`` twin of
the Pallas kernel (``backend="pallas", kernel_exec="scan"``) or its numpy
host backend.  Hit sets, MatchPairs and ``{query, build}`` counts must be
identical; Levenshtein distances are exact small integers on both sides.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.retrieval as ref  # noqa: E402
from repro.core.refnet import ReferenceNet as RefNet  # noqa: E402
from repro_torch.core.counter import CountedDistance  # noqa: E402
from repro_torch.core.refnet import ReferenceNet  # noqa: E402
from repro_torch.data.synthetic import protein_sequences  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

STAT_KEYS = ("query", "build", "dispatches", "build_dispatches")
REF_BACKEND = {"numpy": dict(backend="numpy"),
               "kernel": dict(backend="pallas", kernel_exec="scan")}


def _stats(rs):
    return {k: rs.stats[k] for k in STAT_KEYS}


def _pairs(rs):
    return [m.key() + (m.distance,) for m in rs.hits]


@pytest.fixture(scope="module")
def quickstart():
    """Six sequences of 160 tokens with a planted, mutated copy of part of
    sequence 3 in the query (``examples/quickstart.py``, shrunk)."""
    seqs = protein_sequences(6, 160, n_motifs=48, seed=1)
    rng = np.random.default_rng(0)
    Q = rng.integers(0, 20, size=(44,)).astype(np.int32)
    Q[8:38] = seqs[3][50:80]
    Q[13] = (Q[13] + 1) % 20
    Q[31] = (Q[31] + 7) % 20
    kw = dict(lam=16, lambda0=1, index="refnet", tight_bounds=True,
              num_max=5)
    built = {}
    for be in ("numpy", "kernel"):
        built[be] = (
            Retriever.build(RetrievalConfig("levenshtein", backend=be,
                                            device="cpu", **kw), seqs),
            ref.Retriever.build(ref.RetrievalConfig(
                "levenshtein", **REF_BACKEND[be], **kw), seqs))
    return Q, built


def check_quickstart(quickstart, backend, execution):
    """range / longest / nearest through both packages under one backend
    and execution policy: identical MatchPairs and counts."""
    Q, built = quickstart
    port, refr = built[backend]
    # Levenshtein distances are integers: a coarse nearest() search
    # tolerance finds the same optimum in fewer rounds
    results = []
    for query in (lambda p: p.range(2.0), lambda p: p.longest(2.0),
                  lambda p: p.nearest(3.0, tol=0.5)):
        got = query(port.query(Q).via(execution))
        want = query(refr.query(Q).via(execution))
        assert _pairs(got) == _pairs(want)
        assert _stats(got) == _stats(want)
        assert got.hits
        results.append(got)
    longest = results[1].first
    assert longest.seq_id == 3 and longest.q_len >= 25


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_quickstart_three_query_types_match_reference(quickstart, backend):
    """Batched execution (the host policy runs in
    ``test_torch_retrieval_host.py``)."""
    check_quickstart(quickstart, backend, "batched")


def _trajectories(n, l, seed):
    rng = np.random.default_rng(seed)
    steps = rng.normal(scale=0.3, size=(n, l, 2))
    return (np.cumsum(steps, axis=1)
            + rng.normal(scale=2.0, size=(n, 1, 2))).astype(np.float32)


def test_erp_window_level_matches_reference():
    data = _trajectories(60, 8, seed=17)
    rng = np.random.default_rng(3)
    queries = [(data[i][:ln] + rng.normal(scale=0.05, size=(ln, 2))
                ).astype(np.float32)
               for i, ln in zip((3, 11, 27, 40), (8, 7, 8, 6))]
    kw = dict(index="refnet", tight_bounds=True, num_max=5)
    port = Retriever.build(RetrievalConfig("erp", device="cpu", **kw), data)
    refr = ref.Retriever.build(ref.RetrievalConfig(
        "erp", backend="pallas", kernel_exec="scan", **kw), data)
    for eps in (1.0, 3.0):
        got = port.batch(queries).range(eps)
        want = refr.batch(queries).range(eps)
        assert got.hits == want.hits
        assert _stats(got) == _stats(want)
        assert got.stats["rounds"] == want.stats["rounds"]
    assert any(got.hits)


def test_endpoint_cascade_counts_and_tier_maps_match_reference():
    data = _trajectories(50, 8, seed=5)
    queries = [data[i][:ln] for i, ln in zip((2, 9, 30), (8, 6, 7))]
    kw = dict(index="linear", lb_cascade="endpoint")
    port = Retriever.build(RetrievalConfig("erp", device="cpu", **kw), data)
    refr = ref.Retriever.build(ref.RetrievalConfig(
        "erp", backend="pallas", kernel_exec="scan", **kw), data)
    for execution in ("batched", "host"):
        got = port.batch(queries).via(execution).range(2.5)
        want = refr.batch(queries).via(execution).range(2.5)
        assert got.hits == want.hits
        assert _stats(got) == _stats(want)
        assert got.stats["lb"] == want.stats["lb"] > 0
    assert port.counter.lb_tier_rows == refr._engine.counter.lb_tier_rows
    assert port.counter.lb_tier_pruned == \
        refr._engine.counter.lb_tier_pruned


def ref_net_state(net: RefNet) -> dict:
    """A reference ``ReferenceNet``'s built structure in the port's
    ``to_state`` format."""
    ids = sorted(net.nodes)
    nodes = [net.nodes[i] for i in ids]
    return {
        "root": net.root, "top_level": net.top_level,
        "eps_prime": net.eps_prime, "num_max": net.num_max,
        "tight_bounds": net.tight_bounds,
        "idx": np.asarray(ids, np.int64),
        "level": np.asarray([n.level for n in nodes], np.int64),
        "sub_radius": np.asarray([n.sub_radius for n in nodes], np.float64),
        "children": [list(n.children) for n in nodes],
        "child_dist": [list(n.child_dist) for n in nodes],
        "child_level": [list(n.child_level) for n in nodes],
        "parents": [list(n.parents) for n in nodes],
    }


def test_reference_net_handed_over_queries_identically():
    """A reference-built net loaded into the port (zero evaluations) gives
    identical range hits and query counts, host and batched."""
    from repro.core.batch_engine import BatchEngine as RefEngine
    from repro.core.counter import CountedDistance as RefCounter
    from repro_torch.core.batch_engine import BatchEngine
    rng = np.random.default_rng(9)
    motifs = rng.integers(0, 10, size=(6, 8))
    data = motifs[rng.integers(0, 6, 120)]
    data = np.where(rng.random((120, 8)) < 0.2,
                    rng.integers(0, 10, size=(120, 8)), data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        refnet = RefNet("levenshtein", data, tight_bounds=True, num_max=4,
                        counter=RefCounter(ref.RetrievalConfig(
                            "levenshtein").dist, data)).build_batched()
    state = ref_net_state(refnet)
    counter = CountedDistance(refnet.dist.name and _port_dist(), data,
                              device="cpu")
    net = ReferenceNet.from_state("levenshtein", data, state,
                                  counter=counter)
    assert counter.build_count == 0 and counter.count == 0
    queries = [data[i][:ln] for i, ln in zip((1, 7, 22, 50), (8, 7, 8, 6))]
    refnet.counter.reset()
    for q in queries:
        assert net.range_query(q, 2.0) == refnet.range_query(q, 2.0)
    assert counter.count == refnet.counter.count
    got = BatchEngine(counter).run(
        [net.range_query_plan(2.0) for _ in queries], queries, 2.0)
    want = RefEngine(refnet.counter).run(
        [refnet.range_query_plan(2.0) for _ in queries], queries, 2.0)
    assert got == want
    assert counter.count == refnet.counter.count
    assert counter.dispatches == refnet.counter.dispatches
    assert counter.build_count == 0
    # the port's own round trip is exact
    again = ReferenceNet.from_state("levenshtein", data, net.to_state(),
                                    counter=counter)
    assert again.to_state().keys() == state.keys()
    for k, v in again.to_state().items():
        np.testing.assert_array_equal(np.asarray(v, dtype=object),
                                      np.asarray(state[k], dtype=object))


def _port_dist():
    from repro_torch.distances import get
    return get("levenshtein")


def test_config_round_trips_and_unported_features_raise():
    cfg = RetrievalConfig("levenshtein", lam=16, device="cpu",
                          lb_cascade=True)
    assert RetrievalConfig.from_json(cfg.to_json()) == cfg
    assert cfg.backend == "kernel" and cfg.lb_cascade == "endpoint"
    assert RetrievalConfig("erp").device == "cuda"
    for field in ("interpret", "kernel_exec", "kernel_tile",
                  "kernel_backend"):
        with pytest.raises(ValueError, match="unknown"):
            RetrievalConfig.from_dict({"distance": "erp", field: None})
    # fleet execution builds (it raised before the fleet was ported)
    fleet = RetrievalConfig("erp", execution="fleet", workers=2,
                            device="cpu")
    assert fleet.workers == ("w0", "w1")
    # the comparison indexes build (they raised before they were ported)
    for kind in ("covertree", "mv"):
        built = Retriever.build(RetrievalConfig("erp", index=kind,
                                                device="cpu"),
                                _trajectories(20, 6, seed=1))
        assert built.query(built.index.data[4]).range(0.0).hits == [4]
    with pytest.raises(ValueError, match="backend"):
        RetrievalConfig("erp", backend="pallas")
    data = _trajectories(20, 6, seed=1)
    assert Retriever.build(fleet, data).query(data[4]).range(0.0).hits \
        == [4]
    # the envelope tier under the kernel backend builds and answers, with
    # the same hits as the host envelope tier and as no cascade
    env = Retriever.build(RetrievalConfig("erp", device="cpu",
                                          lb_cascade="envelope"), data)
    r = Retriever.build(RetrievalConfig("erp", device="cpu"), data)
    h = Retriever.build(RetrievalConfig("erp", device="cpu",
                                        backend="numpy",
                                        lb_cascade="envelope"), data)
    want = h.query(data[0]).range(1.0).hits
    assert want and env.query(data[0]).range(1.0).hits == want
    assert r.query(data[0]).lb("envelope").range(1.0).hits == want
    # fleet controls on a non-fleet retriever raise, as in the reference
    with pytest.raises(ValueError, match="fleet"):
        r.elastic()
    with pytest.raises(ValueError, match="fleet"):
        r.serve()
    with pytest.raises(ValueError, match="fleet"):
        r.query(data[0]).dead("w0")
    from repro_torch.core.distributed import FlatNet
    m = Retriever.build(RetrievalConfig(
        "levenshtein", lam=8, device="cpu"),
        protein_sequences(2, 40, seed=2))
    assert isinstance(m.matcher.flat_net(), FlatNet)
