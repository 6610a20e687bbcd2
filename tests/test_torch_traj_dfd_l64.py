"""Long-window trajectory search on the CPU: TRAJ under the discrete
Fréchet distance at windows of 64 points (the ``traj-dfd-l64``
deployment of ``perfbench``), through the fleet's one-shot query.

The port's fleet, on the wavefront kernel's plain version, and the JAX
reference's, in its ``lax.scan`` lane, are built over the same seeded
windows: hits, the one-shot stats and ``device_stats`` must be identical;
and the benchmark's cell runs whole at a tiny size.  The card's half
(``wavefront.schedule``, the schedule counter, the span) is
``test_torch_traj_dfd_l64_gpu.py``.
"""

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.retrieval as ref  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro_torch.data.synthetic import trajectories  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKERS = ["w0", "w1", "w2", "w3"]
#: the deployment's refnet settings and query radius
FLEET = dict(execution="fleet", workers=WORKERS, tight_bounds=True,
             eps_prime=0.5, max_cohort=256, lb_cascade="off")
EPS = 5.25


@pytest.fixture(scope="module")
def fleets():
    prev = ref_registry.set_default_exec("scan")
    try:
        data = trajectories(400, l=64, seed=0)
        rng = np.random.default_rng(3)
        qs = data[rng.integers(0, len(data), 8)].copy()
        qs += rng.normal(scale=0.1 * np.std(data),
                         size=qs.shape).astype(qs.dtype)
        port = Retriever.build(RetrievalConfig("frechet", device="cpu",
                                               **FLEET), data)
        refr = ref.Retriever.build(ref.RetrievalConfig(
            "frechet", backend="pallas", kernel_exec="scan", **FLEET), data)
        yield data, qs, port, refr
    finally:
        ref_registry.set_default_exec(prev)


def test_oneshot_matches_reference(fleets):
    data, qs, port, refr = fleets
    assert port.eval_stats() == refr.eval_stats()
    got = port.batch(qs).via("fleet-oneshot").range(EPS)
    want = refr.batch(qs).via("fleet-oneshot").range(EPS)
    assert got.hits == want.hits
    assert got.stats == want.stats
    assert port.elastic().device_stats == refr.elastic().device_stats
    assert port.elastic().device_stats["total_evals"] > 0
    # every query finds windows, its own among them
    assert all(hs for hs in got.hits)


def test_cell_rehearsal():
    sys.path.insert(0, str(REPO))
    try:
        from perfbench import harness
        res = harness.run_cell(
            "traj-dfd-l64.batch", 2**31 + 5, 1.0, False, device="cpu",
            overrides={"config": {"windows": 300},
                       "cell": {"batch": 4, "pool_batches": 3,
                                "warmup_batches": 1, "sample_queries": 12}},
            log=lambda m: None)
    finally:
        sys.path.remove(str(REPO))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["mismatched_queries"]["value"] == 0
