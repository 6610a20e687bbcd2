"""The port's serve layer against the JAX reference, on the CPU.

* ``run_schedule`` on the virtual clock (seeded Poisson arrivals, a fixed
  cost per merged round) gives hits, merged-round counts and latency
  percentiles identical to the reference's, under both admission
  policies and across a mid-schedule snapshot-swap resize;
* snapshots round-trip (zero evaluations, same hits and counts), and the
  on-disk format is the reference's: a snapshot written by ``repro``
  restores in ``repro_torch`` with the same hits and counts, and vice
  versa; the checkpoint layer writes the reference's ``"a/b/0"`` keys;
* wall-clock ``start`` / ``submit`` with a background resize serves every
  request exactly, and a failure on the serving thread fails the
  requests and re-raises from ``close``; a request served on the wall
  clock completes at the clock's reading after its last round;
* the ``launch/serve.py`` CLI runs with ``--device cpu``.

Fleets: the port's ``kernel`` backend on ``device="cpu"``, the
reference's ``pallas`` backend in its ``lax.scan`` lane.  Levenshtein
distances are exact small integers, so everything compared is equal.
"""

import json
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import registry as ref_registry  # noqa: E402
from repro.launch.elastic import ElasticIndex as RefElastic  # noqa: E402
from repro import serve as ref_serve  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.data.synthetic import proteins  # noqa: E402
from repro_torch.launch.elastic import ElasticIndex  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

WORKERS = ["a", "b", "c"]


@pytest.fixture(autouse=True)
def scan_exec():
    prev = ref_registry.set_default_exec("scan")
    yield
    ref_registry.set_default_exec(prev)


def _fleets(n=150, seed=7, workers=WORKERS):
    data = proteins(n, seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        port = ElasticIndex("levenshtein", data, list(workers),
                            device="cpu")
        refr = RefElastic("levenshtein", data, list(workers),
                          backend="pallas", kernel_exec="scan")
    return data, port, refr


def _oracle(fleet, qs, eps):
    return [fleet.range_query(q, eps, batched=False) for q in qs]


@pytest.mark.parametrize("admission", ["tick", "greedy"])
def test_run_schedule_matches_reference(admission, tmp_path):
    data, port, refr = _fleets()
    qs = [data[i] for i in range(1, 40, 3)]
    arrivals = serve.poisson_schedule(1.0, 40.0, seed=7)[:len(qs)]
    np.testing.assert_array_equal(
        arrivals, ref_serve.poisson_schedule(1.0, 40.0, seed=7)[:len(qs)])
    want_hits = _oracle(port, qs, 2.0)
    assert want_hits == _oracle(refr, qs, 2.0)
    runs = []
    for mod, fleet, sub in ((serve, port, "port"), (ref_serve, refr, "ref")):
        eng = mod.ServeEngine(fleet, mod.ServeConfig(
            eps=2.0, admission=admission, snapshot_dir=tmp_path / sub))
        reqs = eng.run_schedule(qs, arrivals, resize_at=6.0,
                                resize_to=["a", "b"])
        runs.append(([r.hits for r in reqs], [r.rounds for r in reqs],
                     eng.engine_stats(), eng.latency_stats(),
                     eng.fleet.eval_count()))
    assert runs[0] == runs[1]
    assert runs[0][0] == want_hits
    assert runs[0][2]["swaps"] == 1


def test_continuous_rounds_below_sequential_rounds():
    data, port, _ = _fleets(n=120)
    qs = [data[i] for i in range(0, 60, 5)]
    r0 = port.device_stats["rounds"]
    seq = [port.range_query_batch([q], 2.0)[0] for q in qs]
    seq_rounds = port.device_stats["rounds"] - r0
    eng = serve.ServeEngine(port, serve.ServeConfig(eps=2.0))
    reqs = eng.run_schedule(qs, np.linspace(0.0, 4.0, len(qs)))
    assert [r.hits for r in reqs] == seq
    assert eng.engine_stats()["rounds"] < seq_rounds


def _hits(fleet, qs):
    return fleet.range_query_batch(list(qs), 2.0)


def test_snapshot_round_trip_spends_nothing(tmp_path):
    data, port, _ = _fleets()
    qs = data[[3, 40, 77]]
    want = _hits(port, qs)
    counts = port.eval_count()
    snap = serve.FleetSnapshotManager(tmp_path)
    step = snap.save(port, block=True)
    clone = snap.restore(step, device="cpu")
    assert clone.eval_count() == counts
    assert clone.device == torch.device("cpu")
    assert clone.shards["a"].net.counter.device == torch.device("cpu")
    assert _hits(clone, qs) == want
    assert clone.range_query_batch(list(qs), 2.0, mode="oneshot") == want
    for w in WORKERS:
        a, b = port.shards[w], clone.shards[w]
        np.testing.assert_array_equal(a.gids, b.gids)
        np.testing.assert_array_equal(a.flat.members, b.flat.members)
    assert snap.restore(device="cpu").eval_count() == counts  # latest


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_snapshots_cross_restore_between_packages(tmp_path, writer):
    data, port, refr = _fleets()
    qs = data[[3, 40, 77, 120]]
    want = _hits(port, qs)
    assert _hits(refr, qs) == want
    if writer == "repro":
        ref_serve.FleetSnapshotManager(tmp_path).save(refr, block=True)
        clone = serve.FleetSnapshotManager(tmp_path).restore(device="cpu")
        assert clone.backend == "kernel"
    else:
        serve.FleetSnapshotManager(tmp_path).save(port, block=True)
        clone = ref_serve.FleetSnapshotManager(tmp_path).restore()
        assert clone.backend == "pallas"
    assert clone.eval_count() == port.eval_count() == refr.eval_count()
    assert _hits(clone, qs) == want
    assert clone.range_query_batch(list(qs), 2.0, mode="oneshot") == want


def test_checkpoint_keys_and_files_are_the_references(tmp_path):
    tree = {"b": [np.arange(3), (np.ones((2, 2)), None)],
            "a": {"y": np.float32(2.5), "x": np.zeros(4, np.int64)}}
    flat = checkpoint._flatten(tree)
    assert flat.keys() == ref_ckpt._flatten(tree).keys()
    assert list(flat) == ["a/x", "a/y", "b/0", "b/1/0"]
    m = checkpoint.CheckpointManager(tmp_path / "p", keep=2)
    for step in range(3):
        m.save(step, tree, extra={"k": step})
    m.wait()
    assert m.latest_step() == 2
    assert len(list((tmp_path / "p").glob("step_*"))) == 2
    back, meta = ref_ckpt.CheckpointManager(tmp_path / "p").restore(tree)
    assert meta["k"] == 2
    np.testing.assert_array_equal(back["b"][1][0], np.ones((2, 2)))
    ref_ckpt.CheckpointManager(tmp_path / "r").save(7, tree, block=True)
    got, meta = checkpoint.CheckpointManager(tmp_path / "r").restore(tree)
    assert meta["step"] == 7 and isinstance(got["b"][1], tuple)
    np.testing.assert_array_equal(got["a"]["x"], tree["a"]["x"])
    with pytest.raises(ValueError, match="shape"):
        checkpoint._unflatten_into({"a": {"x": np.zeros(5)}}, flat)


def test_wall_clock_serving_with_background_resize(tmp_path):
    data, port, _ = _fleets(n=120)
    qs = [data[i] for i in range(0, 48, 3)]
    want = _oracle(port, qs, 2.0)
    eng = serve.ServeEngine(port, serve.ServeConfig(
        eps=2.0, snapshot_dir=tmp_path)).start()
    try:
        first = [eng.submit(q) for q in qs[:4]]
        eng.resize(["a", "b", "c", "d"], block=False)
        load = serve.OpenLoopLoadGen(eng, qs[4:], qps=400.0, seed=0).start()
        rest = load.join(timeout=60)
        assert [r.result(timeout=60) for r in first] == want[:4]
        deadline = time.monotonic() + 60
        while eng.swaps == 0 and time.monotonic() < deadline:
            time.sleep(1e-3)   # the swap lands at a round boundary
    finally:
        eng.close(drain=True)
    reqs = first + rest
    assert not any(r.failed for r in reqs)
    assert [r.hits for r in reqs] == want
    assert eng.swaps == 1 and eng.fleet.workers == ["a", "b", "c", "d"]
    assert eng._thread is None


def test_a_failing_tick_fails_the_requests_and_close_raises():
    data, port, _ = _fleets(n=60)
    eng = serve.ServeEngine(port, serve.ServeConfig(eps=2.0))

    def broken(*args):
        raise RuntimeError("kernel launch failed")

    eng._engine.evaluate = broken
    eng.start()
    req = eng.submit(data[0])
    with pytest.raises(RuntimeError, match="failed") as info:
        req.result(timeout=30)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert req.failed and req.done
    with pytest.raises(RuntimeError, match="serving failed"):
        eng.close()
    with pytest.raises(RuntimeError, match="failed"):
        eng.submit(data[1])


def test_a_failing_background_resize_surfaces(tmp_path):
    data, port, _ = _fleets(n=60)
    eng = serve.ServeEngine(port, serve.ServeConfig(
        eps=2.0, snapshot_dir=tmp_path)).start()
    assert eng.submit(data[0]).result(timeout=60) == [0]
    eng.resize([], block=False)      # an empty worker set cannot serve
    deadline = time.monotonic() + 60
    while eng.error is None and time.monotonic() < deadline:
        time.sleep(1e-3)
    assert "resize" in str(eng.error)
    with pytest.raises(RuntimeError, match="failed"):
        eng.submit(data[0])
    with pytest.raises(RuntimeError, match="serving failed"):
        eng.close()


def test_wall_clock_completion_is_read_after_its_round():
    """A round that takes time shows in the latency: the clock advances
    one unit in each merged round, and a request completes at the clock's
    reading after its last round, not at its tick's start."""
    data = proteins(60, seed=7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        port = ElasticIndex("levenshtein", data, list(WORKERS),
                            device="cpu")
    now = [0.0]
    eng = serve.ServeEngine(port, serve.ServeConfig(eps=2.0),
                            clock=lambda: now[0])
    evaluate = eng._engine.evaluate

    def a_round_takes_one_unit(*args):
        now[0] += 1.0
        return evaluate(*args)

    eng._engine.evaluate = a_round_takes_one_unit
    req = eng.submit(data[5])
    starts = []
    while not req.done and len(starts) < 100:
        starts.append(now[0])
        eng.tick()
    assert req.done and not req.failed
    assert req.hits == port.range_query(data[5], 2.0, batched=False)
    assert req.rounds >= 1 and now[0] >= 1.0
    assert req.t_complete == now[0] > starts[-1]
    assert eng.latency_stats()["p50"] == req.latency == now[0]


def test_request_queue_and_facade_serve():
    from repro_torch.retrieval import RetrievalConfig, Retriever
    q = serve.RequestQueue()
    a = q.submit(np.zeros(3), 1.0, now=1.0)
    b = q.submit(np.ones(3), 2.0, now=2.0)
    assert [r.rid for r in q.take(5)] == [a.rid, b.rid] and len(q) == 0
    data = proteins(40, seed=3)
    r = Retriever.build(RetrievalConfig(
        "levenshtein", execution="fleet", workers=2, device="cpu",
        serve_max_inflight=4, serve_admission="greedy"), data)
    eng = r.serve(2.0)
    assert eng.config.max_inflight == 4 and eng.config.admission == "greedy"
    reqs = eng.run_schedule([data[5], data[9]], [0.0, 0.5])
    assert [x.hits for x in reqs] == r.batch(
        [data[5], data[9]]).via("host").range(2.0).hits
    assert eng.latency_stats()["n"] == 2


def test_serve_cli_runs_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import serve as cli
    assert cli.main(["--device", "cpu", "--n-windows", "160",
                     "--queries", "6", "--qps", "200",
                     "--snapshot-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["requests"] == 6
    assert out["swaps"] == 1 and out["shards"] == 4
