"""The port's LB-cascade envelope tier against the JAX reference, on the CPU.

* the ``lb:{dtw,erp,frechet}`` specs (torch ops on the operands' device)
  against ``repro.kernels.registry.get_envelope(name).batch`` on ragged
  rows with ``lx != ly``: bounds within ``rtol = atol = 1e-5`` (f32 sums
  of up to ~40 terms, associated differently), identical ``pruned`` masks;
* ``kernels/dispatch.packed_envelope``: the same bounds and the same
  ``lb_rows`` / ``lb_pruned`` tier counts;
* the counter's envelope tier under the ``kernel`` backend (the bound on
  the device, over windows gathered from the window table there) against
  the reference's ``pallas`` backend in its ``lax.scan`` lane, on shrunk
  ``benchmarks/bench_bounds.py`` TRAJ cells: identical hits, ``{query,
  build}`` counts and per-tier ``lb_rows`` / ``lb_pruned``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.retrieval as ref  # noqa: E402
from repro.kernels import dispatch as ref_dispatch  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

RTOL = ATOL = 1e-5


def _rows(rng, B, Lx, Ly, d):
    """Ragged random-walk rows; ``d == 0`` gives 2-D ``(B, L)`` rows."""
    shape = (lambda L: (B, L)) if d == 0 else (lambda L: (B, L, d))
    xs = np.cumsum(rng.normal(scale=0.5, size=shape(Lx)), 1).astype(
        np.float32)
    ys = np.cumsum(rng.normal(scale=0.5, size=shape(Ly)), 1).astype(
        np.float32)
    lx = rng.integers(1, Lx + 1, B)
    ly = rng.integers(1, Ly + 1, B)
    lx[0], ly[0] = Lx, Ly
    return xs, ys, lx, ly


@pytest.mark.parametrize("d", [0, 2])
@pytest.mark.parametrize("name", ["dtw", "erp", "frechet"])
def test_envelope_spec_matches_reference(name, d):
    rng = np.random.default_rng(11 + d)
    xs, ys, lx, ly = _rows(rng, 96, 13, 9, d)
    eps = rng.uniform(0.0, 6.0, 96).astype(np.float32)
    want = ref_registry.get_envelope(name).batch(xs, ys, lx, ly, eps=eps)
    got = registry.get_envelope(name).batch(xs, ys, lx, ly, eps=eps,
                                            device="cpu")
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.pruned.numpy(),
                                  np.asarray(want.pruned))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    assert 0 < int(got.pruned.sum()) < 96   # both verdicts occur
    assert registry.has_envelope(name) and ref_registry.has_envelope(name)


def test_envelope_registry_names_match_reference():
    assert not registry.has_envelope("levenshtein")
    assert registry.names() == ref_registry.names()


def test_packed_envelope_bounds_and_tier_counts_match_reference():
    rng = np.random.default_rng(5)
    xs, ys, lx, ly = _rows(rng, 70, 12, 12, 2)
    dispatch.STATS.reset()
    ref_dispatch.STATS.reset()
    for eps in (0.5, 2.0, 4.0):
        got = dispatch.packed_envelope("erp", xs, torch.as_tensor(ys), lx,
                                       ly, eps=eps, device="cpu")
        want = ref_dispatch.packed_envelope("erp", xs, ys, lx, ly, eps=eps)
        np.testing.assert_allclose(got.dist, np.asarray(want.dist),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got.pruned, np.asarray(want.pruned))
    assert dispatch.STATS.lb_rows == ref_dispatch.STATS.lb_rows \
        == {"envelope": 210}
    assert dispatch.STATS.lb_pruned == ref_dispatch.STATS.lb_pruned
    assert 0 < dispatch.STATS.lb_pruned["envelope"] < 210


def _queries(data, n, seed):
    """``benchmarks/common.mutate_queries`` for float rows."""
    rng = np.random.default_rng(seed)
    qs = data[rng.integers(0, len(data), n)].copy()
    return qs + rng.normal(scale=0.1 * np.std(data),
                           size=qs.shape).astype(qs.dtype)


def _check_tier(port, refr, qs, eps, tier):
    got = port.batch(qs).via("batched").lb(tier).range(eps)
    want = refr.batch(qs).via("batched").lb(tier).range(eps)
    assert got.hits == want.hits
    for k in ("query", "build", "dispatches", "lb"):
        assert got.stats[k] == want.stats[k], k
    return got


@pytest.mark.parametrize("name", ["dtw", "erp"])
def test_counter_envelope_tier_matches_reference_on_traj_cells(name):
    """``bench_bounds.py``'s gated linear-scan cells, shrunk (160 windows,
    4 queries): hits and counts per tier, and the counter's tier maps."""
    data = synthetic.trajectories(160, seed=0)
    qs = _queries(data, 4, seed=2)
    port = Retriever.build(RetrievalConfig(name, index="linear",
                                           device="cpu"), data)
    refr = ref.Retriever.build(ref.RetrievalConfig(
        name, index="linear", backend="pallas", kernel_exec="scan"), data)
    for eps in (1.0, 2.0, 4.0):
        off = _check_tier(port, refr, qs, eps, "off")
        env = _check_tier(port, refr, qs, eps, "envelope")
        assert env.hits == off.hits
    pc, rc = port.counter, refr._engine.counter
    assert pc.lb_tier_rows == rc.lb_tier_rows
    assert pc.lb_tier_pruned == rc.lb_tier_pruned
    assert pc.lb_tier_pruned["envelope"] > 0


def test_counter_envelope_tier_on_refnet_matches_reference():
    """``bench_bounds.py``'s refnet diagnostic, shrunk: the envelope tier
    under the batched frontier engine over a sequentially built net."""
    data = synthetic.trajectories(120, seed=0)
    qs = _queries(data, 4, seed=2)
    kw = dict(eps_prime=2.0, bulk_build=False)
    port = Retriever.build(RetrievalConfig("erp", device="cpu", **kw), data)
    refr = ref.Retriever.build(ref.RetrievalConfig(
        "erp", backend="pallas", kernel_exec="scan", **kw), data)
    for eps in (1.0, 2.0):
        _check_tier(port, refr, qs, eps, "envelope")
    assert port.counter.lb_tier_rows == refr._engine.counter.lb_tier_rows
    assert port.counter.lb_tier_pruned == \
        refr._engine.counter.lb_tier_pruned


@pytest.mark.parametrize("name", ["dtw", "erp"])
def test_eps_exactly_at_an_envelope_bound_keeps_the_host_hits(name):
    """ε set exactly at envelope bounds of the TRAJ cells, the reference's
    bound values and the port's own (which differ by up to ~1e-5 of the
    bound): a row whose bound lies at ε is pruned on neither side
    (``lb > eps`` prunes), so the envelope tier's hits equal the host's
    (the numpy backend, no bound) and the reference's envelope tier's."""
    data = synthetic.trajectories(160, seed=0)
    qs = _queries(data, 4, seed=2)
    Q, N = len(qs), len(data)
    xs = np.repeat(qs, N, axis=0)
    ys = np.tile(data, (Q, 1, 1))
    ref_lb = np.asarray(ref_registry.get_envelope(name).batch(
        xs, ys, eps=np.inf).dist)
    port_lb = registry.get_envelope(name).batch(
        xs, ys, eps=np.inf, device="cpu").dist.numpy()
    port = Retriever.build(RetrievalConfig(name, index="linear",
                                           device="cpu"), data)
    host = Retriever.build(RetrievalConfig(name, index="linear",
                                           backend="numpy", device="cpu"),
                           data)
    refr = ref.Retriever.build(ref.RetrievalConfig(
        name, index="linear", backend="pallas", kernel_exec="scan"), data)
    # bounds among the smaller ones, where ε decides hits and prunes both
    pick = np.quantile(ref_lb, [0.02, 0.1, 0.3])
    checked = 0
    for lb in (ref_lb, port_lb):
        for q in pick:
            eps = float(lb[np.argmin(np.abs(lb - q))])
            want = host.batch(qs).range(eps)
            got = port.batch(qs).via("batched").lb("envelope").range(eps)
            assert got.hits == want.hits, eps
            assert got.hits == refr.batch(qs).via("batched").lb(
                "envelope").range(eps).hits
            assert port.counter.lb_tier_pruned.get("envelope", 0) > 0
            checked += sum(len(h) for h in want.hits)
    assert checked > 0
