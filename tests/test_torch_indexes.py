"""The paper's comparison indexes in the port against the JAX reference, on
the CPU: the cover tree (``core/covertree.py``) and Maximum-Variance
reference indexing (``core/refindex.py``), directly and through the
facade.

The same seeded windows go into both packages.  The port evaluates on its
``kernel`` backend on ``device="cpu"`` (the wavefront kernel's plain torch
version) or on its numpy host backend; the reference on its numpy host
backend.  Hit sets, ``{query, build}`` counts, dispatches, MV's chosen
references and ``stats()`` must be identical.  Levenshtein distances are
exact small integers, so MV's table is bit-equal; ERP's are f32 sums whose
order may differ, so its table is held within ``rtol = 1e-6``.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.retrieval as ref  # noqa: E402
from repro.core import distributed as ref_dist  # noqa: E402
from repro.core.counter import CountedDistance as RefCounter  # noqa: E402
from repro.core.covertree import CoverTree as RefCoverTree  # noqa: E402
from repro.core.refindex import MVReferenceIndex as RefMV  # noqa: E402
from repro.distances import get as ref_get  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core.counter import CountedDistance  # noqa: E402
from repro_torch.core.covertree import CoverTree  # noqa: E402
from repro_torch.core.refindex import MVReferenceIndex  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    protein_sequences, proteins, trajectories)
from repro_torch.distances import get  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

#: distance -> (windows, eps_prime, range sizes), as the paper's Figs. 8/10
CASES = {
    "levenshtein": (lambda: proteins(150, seed=4), 1.0, (1.0, 2.0, 4.0)),
    "erp": (lambda: trajectories(120, seed=4), 2.0, (1.0, 2.0, 4.0)),
}
QUERIES = (3, 41, 97)
STAT_KEYS = ("query", "build", "dispatches", "build_dispatches")


def _counts(counter):
    return (counter.count, counter.build_count, counter.dispatches,
            counter.build_dispatches)


def _port_counter(name, data, backend):
    return CountedDistance(get(name), data, backend=backend, device="cpu")


def _sweep(index, data, ranges):
    """Hits of every query at every range, then the counter's buckets."""
    hits = [index.range_query(data[q], eps) for eps in ranges
            for q in QUERIES]
    return hits, _counts(index.counter)


@pytest.mark.parametrize("backend", ["kernel", "numpy"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_covertree_matches_reference(name, backend):
    gen, eps_prime, ranges = CASES[name]
    data = gen()
    port = CoverTree(get(name), data, eps_prime=eps_prime,
                     counter=_port_counter(name, data, backend)).build()
    want = RefCoverTree(ref_get(name), data, eps_prime=eps_prime,
                        counter=RefCounter(ref_get(name), data)).build()
    port.check_invariants()
    assert port.stats() == want.stats()
    assert port.root == want.root and port.top_level == want.top_level
    assert _sweep(port, data, ranges) == _sweep(want, data, ranges)


@pytest.mark.parametrize("name", sorted(CASES))
def test_covertree_bulk_build_matches_reference_and_sequential(name):
    gen, eps_prime, ranges = CASES[name]
    data = gen()
    port = CoverTree(get(name), data, eps_prime=eps_prime,
                     counter=_port_counter(name, data, "kernel")
                     ).build_batched()
    want = RefCoverTree(ref_get(name), data, eps_prime=eps_prime,
                        counter=RefCounter(ref_get(name), data)
                        ).build_batched()
    port.check_invariants()  # single parent: only the nearest owner kept
    assert all(len(n.parents) == 1 for i, n in port.nodes.items()
               if i != port.root)
    assert port.stats() == want.stats()
    got_hits, got_counts = _sweep(port, data, ranges)
    assert (got_hits, got_counts) == _sweep(want, data, ranges)
    seq = CoverTree(get(name), data, eps_prime=eps_prime,
                    counter=_port_counter(name, data, "numpy")).build()
    assert _sweep(seq, data, ranges)[0] == got_hits


@pytest.mark.parametrize("backend", ["kernel", "numpy"])
@pytest.mark.parametrize("n_refs", [5, 12])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mv_matches_reference(name, n_refs, backend):
    gen, _, ranges = CASES[name]
    data = gen()
    port = MVReferenceIndex(get(name), data, n_refs=n_refs, sample=64,
                            counter=_port_counter(name, data, backend)
                            ).build()
    want = RefMV(ref_get(name), data, n_refs=n_refs, sample=64,
                 counter=RefCounter(ref_get(name), data)).build()
    assert port.refs == want.refs
    assert port.table.dtype == want.table.dtype == np.float32
    if name == "levenshtein":
        np.testing.assert_array_equal(port.table, want.table)
    else:
        np.testing.assert_allclose(port.table, want.table, rtol=1e-6)
    assert port.stats() == want.stats()
    # construction lands in the build bucket: queries start at zero
    assert _counts(port.counter)[::2] == (0, 0)
    assert _sweep(port, data, ranges) == _sweep(want, data, ranges)


def test_mv_build_chunks_dispatches_like_the_reference(monkeypatch):
    """Each ``_CHUNK_ROWS`` chunk of a pair block is one dispatch."""
    data = proteins(90, seed=6)
    monkeypatch.setattr(MVReferenceIndex, "_CHUNK_ROWS", 128)
    monkeypatch.setattr(RefMV, "_CHUNK_ROWS", 128)
    assert MVReferenceIndex._CHUNK_ROWS == 128
    port = MVReferenceIndex(get("levenshtein"), data, n_refs=3,
                            counter=_port_counter("levenshtein", data,
                                                  "kernel")).build()
    want = RefMV(ref_get("levenshtein"), data, n_refs=3,
                 counter=RefCounter(ref_get("levenshtein"), data)).build()
    # 12 candidates x 90 samples, then 3 references x 90 windows
    assert port.counter.build_dispatches == -(-12 * 90 // 128) \
        + -(-3 * 90 // 128) == want.counter.build_dispatches
    assert _counts(port.counter) == _counts(want.counter)
    np.testing.assert_array_equal(port.table, want.table)


# -- the facade ---------------------------------------------------------------

def _stats(rs):
    return {k: rs.stats[k] for k in STAT_KEYS}


@pytest.mark.parametrize("execution", ["host", "batched"])
@pytest.mark.parametrize("index", ["covertree", "mv"])
def test_facade_window_level_matches_reference(index, execution):
    data = trajectories(100, seed=9)
    kw = dict(index=index, eps_prime=2.0, mv_refs=6)
    port = Retriever.build(RetrievalConfig("erp", device="cpu", **kw), data)
    want = ref.Retriever.build(ref.RetrievalConfig("erp", **kw), data)
    qs = data[[2, 30, 77]]
    for eps in (1.0, 3.0):
        got = port.batch(qs).via(execution).range(eps)
        exp = want.batch(qs).via(execution).range(eps)
        assert got.hits == exp.hits
        assert _stats(got) == _stats(exp)
    if index == "mv":
        assert port.index.refs == want.index.refs


@pytest.mark.parametrize("execution", ["host", "batched"])
@pytest.mark.parametrize("index", ["covertree", "mv"])
def test_facade_matching_pipeline_matches_reference(index, execution):
    seqs = protein_sequences(4, 120, seed=3)
    rng = np.random.default_rng(1)
    Q = seqs[2][20:64].copy()
    Q[[5, 30]] = rng.integers(0, 20, 2)
    kw = dict(lam=16, lambda0=1, index=index, mv_refs=4,
              execution=execution)
    port = Retriever.build(RetrievalConfig("levenshtein", device="cpu",
                                           **kw), seqs)
    want = ref.Retriever.build(ref.RetrievalConfig("levenshtein", **kw),
                               seqs)
    for eps in (1.0, 3.0):
        got, exp = port.query(Q).range(eps), want.query(Q).range(eps)
        assert [m.key() + (m.distance,) for m in got.hits] \
            == [m.key() + (m.distance,) for m in exp.hits]
        assert _stats(got) == _stats(exp)


@pytest.fixture
def scan_exec():
    prev = ref_registry.set_default_exec("scan")
    yield
    ref_registry.set_default_exec(prev)


def test_covertree_flat_net_matches_reference_device_query(scan_exec):
    seqs = protein_sequences(3, 120, seed=2)
    kw = dict(lam=16, lambda0=1, index="covertree")
    got = Retriever.build(RetrievalConfig("levenshtein", device="cpu",
                                          **kw), seqs).matcher.flat_net()
    want = ref.Retriever.build(ref.RetrievalConfig("levenshtein", **kw),
                               seqs).matcher.flat_net()
    np.testing.assert_array_equal(got.members, want.members)
    np.testing.assert_array_equal(got.pivot_ids, want.pivot_ids)
    np.testing.assert_array_equal(got.member_dist, want.member_dist)
    qs = got.data[[1, 9, 33]]
    for eps in (1.0, 2.0):
        hits, stats = dist_mod.device_range_query(got, qs, eps,
                                                  device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ref_hits, ref_stats = ref_dist.device_range_query(want, qs, eps)
        np.testing.assert_array_equal(hits, np.asarray(ref_hits))
        assert stats["member_evals"] == int(ref_stats["member_evals"])
        np.testing.assert_array_equal(
            hits, dist_mod.host_reference_hits(got, qs, eps))


def test_mv_refs_config_round_trips_and_validates():
    cfg = RetrievalConfig("levenshtein", index="mv", mv_refs=50,
                          device="cpu")
    assert RetrievalConfig.from_json(cfg.to_json()) == cfg
    assert RetrievalConfig("erp").mv_refs == 5
    with pytest.raises(ValueError, match="mv_refs"):
        RetrievalConfig("erp", index="mv", mv_refs=0)
    # the config and the reference's agree on every shared field's JSON
    want = ref.RetrievalConfig("levenshtein", index="mv", mv_refs=50)
    assert cfg.to_dict()["mv_refs"] == want.to_dict()["mv_refs"] == 50
