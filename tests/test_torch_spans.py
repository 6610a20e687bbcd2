"""The port's tracer (``repro_torch.spans``) on the CPU: off by default
and free of records, nesting, request ids, self time, per-thread stacks
(also under contention), overflow, collector pauses, profiler ranges, and the spans of a fleet's
one-shot query and of its build."""

import gc
import sys
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.data.synthetic import proteins, trajectories  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

WORKERS = ["w0", "w1", "w2", "w3"]
#: the spans of one one-shot batch whose survivors reach the kernel, in
#: start order (collector pauses aside)
ONESHOT = ["retriever.range", "fleet.oneshot", "oneshot.upload",
           "oneshot.pivots", "oneshot.filter", "oneshot.wait",
           "oneshot.survivors", "oneshot.fetch", "oneshot.wait",
           "fleet.map_hits"]


@pytest.fixture
def tracer():
    """The tracer on with fresh records; off and empty afterwards."""
    spans.reset()
    spans.enable()
    try:
        yield spans
    finally:
        spans.disable()
        spans.reset()


def _by_name(recs, name):
    return np.flatnonzero(recs.name == name)


def _named(recs):
    """Records without collector pauses, in start order."""
    keep = np.flatnonzero(recs.name != spans.GC)
    return keep[np.argsort(recs.start_ns[keep], kind="stable")]


def test_off_by_default_records_nothing():
    spans.disable()
    spans.reset()
    a, b = spans.span("a.x"), spans.span("b.y")
    assert a is b is spans.NOOP
    with a:
        with b:
            gc.collect()
    assert len(spans.records()) == 0


def test_nesting_parents_and_request_ids(tracer):
    with spans.span("call.a"):
        with spans.span("phase.b"):
            with spans.span("wait.c"):
                pass
        with spans.span("phase.d"):
            pass
    with spans.span("call.e"):
        with spans.span("phase.f"):
            pass
    r = spans.records()
    assert list(r.name) == ["call.a", "phase.b", "wait.c", "phase.d",
                            "call.e", "phase.f"]
    slot = dict(zip(r.name, r.slot))
    parent = dict(zip(r.name, r.parent))
    assert parent == {"call.a": -1, "phase.b": slot["call.a"],
                      "wait.c": slot["phase.b"],
                      "phase.d": slot["call.a"], "call.e": -1,
                      "phase.f": slot["call.e"]}
    rid = dict(zip(r.name, r.rid))
    assert rid["call.a"] == rid["phase.b"] == rid["wait.c"] \
        == rid["phase.d"] != rid["call.e"] == rid["phase.f"]
    assert (r.end_ns >= r.start_ns).all() and r.overflow == 0


def test_self_time(tracer):
    with spans.span("outer"):
        time.sleep(0.002)
        with spans.span("eval"):
            time.sleep(0.003)
        with spans.span("plan"):
            time.sleep(0.001)
    r = spans.records()
    outer, ev, plan = (_by_name(r, n)[0] for n in ("outer", "eval", "plan"))
    dur = r.dur_ns
    own = r.self_ns()
    assert own[outer] == dur[outer] - dur[ev] - dur[plan]
    assert own[ev] == dur[ev] and own[plan] == dur[plan]
    assert own[outer] >= 2_000_000
    only_eval = r.self_ns(children=("eval",))
    assert only_eval[outer] == dur[outer] - dur[ev]


def test_each_thread_has_its_own_stack(tracer):
    both_open = threading.Barrier(2, timeout=30)
    inner_done = threading.Barrier(2, timeout=30)

    def serve(tag):
        with spans.span(f"root.{tag}"):
            both_open.wait()
            with spans.span(f"child.{tag}"):
                inner_done.wait()

    threads = [threading.Thread(target=serve, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    r = spans.records()
    slot = dict(zip(r.name, r.slot))
    parent = dict(zip(r.name, r.parent))
    rid = dict(zip(r.name, r.rid))
    for tag in "ab":
        assert parent[f"root.{tag}"] == -1
        assert parent[f"child.{tag}"] == slot[f"root.{tag}"]
        assert rid[f"child.{tag}"] == rid[f"root.{tag}"]
    assert rid["root.a"] != rid["root.b"]


def test_threads_under_contention_keep_their_own_parents(tracer):
    """More threads than cores, switching every microsecond: no slot or
    request id is handed out twice, and every child names its own
    thread's root."""
    n_threads, n_calls = 16, 200
    start = threading.Barrier(n_threads, timeout=60)

    def serve(k):
        start.wait()
        for _ in range(n_calls):
            with spans.span(f"root.{k}"):
                with spans.span(f"child.{k}"):
                    pass

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    r = spans.records()
    roots = np.char.startswith(r.name.astype(str), "root.")
    assert len(r) - len(_by_name(r, spans.GC)) == 2 * n_threads * n_calls
    assert len(np.unique(r.slot)) == len(r)
    assert len(np.unique(r.rid[roots])) == n_threads * n_calls
    kids = np.flatnonzero(np.char.startswith(r.name.astype(str), "child."))
    up = r.rows(r.parent[kids])
    assert (up >= 0).all()
    assert [n.split(".")[1] for n in r.name[up]] \
        == [n.split(".")[1] for n in r.name[kids]]
    assert (r.rid[up] == r.rid[kids]).all()


def test_overflow_is_counted_not_grown(tracer):
    gc.disable()
    try:
        spans.reset(capacity=4)
        for i in range(10):
            with spans.span(f"s.{i % 3}"):
                pass
        r = spans.records()
    finally:
        gc.enable()
    assert len(r) == 4 and r.overflow == 6
    assert list(r.name) == ["s.0", "s.1", "s.2", "s.0"]
    assert spans.records().overflow == 6      # reading takes no record


def test_collector_pauses_are_spans(tracer):
    with spans.span("call.gc"):
        gc.collect()
    gc.collect()
    r = spans.records()
    pauses = _by_name(r, spans.GC)
    call = _by_name(r, "call.gc")[0]
    assert len(pauses) >= 2
    inside = pauses[r.parent[pauses] == r.slot[call]]
    assert len(inside) >= 1 and (r.rid[inside] == r.rid[call]).all()
    assert (r.start_ns[inside] >= r.start_ns[call]).all()
    assert (r.end_ns[inside] <= r.end_ns[call]).all()
    outside = pauses[r.parent[pauses] == -1]
    assert len(outside) >= 1 and (r.rid[outside] == -1).all()
    spans.disable()
    n = len(spans.records())
    gc.collect()
    assert len(spans.records()) == n


def test_spans_open_profiler_ranges_while_it_records(tracer):
    from torch.profiler import ProfilerActivity, profile
    with spans.span("before.profile"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("phase.one"):
            with spans.span("phase.two"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"phase.one", "phase.two"} <= names
    assert "before.profile" not in names
    assert set(spans.records().name) - {spans.GC} == {
        "before.profile", "phase.one", "phase.two"}


def _fleet(dist, n=160, seed=3):
    data = proteins(n, seed=seed) if dist == "levenshtein" \
        else trajectories(n, seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r = Retriever.build(RetrievalConfig(
            dist, execution="fleet", workers=WORKERS, device="cpu"), data)
    return data, r


def _queries(data, seed=5):
    rng = np.random.default_rng(seed)
    qs = data[rng.integers(0, len(data), 8)].copy()
    if qs.dtype.kind in "iu":
        flips = rng.random(qs.shape) < 0.1
        qs[flips] = rng.integers(0, int(data.max()) + 1, flips.sum())
    else:
        qs += rng.normal(scale=0.1, size=qs.shape).astype(qs.dtype)
    return qs


@pytest.mark.parametrize("dist, eps", [("levenshtein", 2.0), ("erp", 3.0)])
def test_oneshot_batch_spans(dist, eps):
    data, r = _fleet(dist)
    qs = _queries(data)

    def answer():
        return r.batch(qs).via("fleet-oneshot").range(eps).hits

    spans.disable()
    spans.reset()
    off = answer()
    assert len(spans.records()) == 0
    spans.reset()
    spans.enable()
    try:
        on = [answer(), answer()]
        recs = spans.records()
    finally:
        spans.disable()
        spans.reset()
    assert on[0] == on[1] == off
    assert any(off)
    order = _named(recs)
    assert list(recs.name[order]) == ONESHOT * 2
    for call in (order[:len(ONESHOT)], order[len(ONESHOT):]):
        names, slots = recs.name[call], recs.slot[call]
        parent = dict(zip(slots, recs.parent[call]))
        slot_of = {n: s for n, s in zip(names, slots) if n != "oneshot.wait"}
        assert len(set(recs.rid[call])) == 1
        assert parent[slot_of["retriever.range"]] == -1
        assert parent[slot_of["fleet.oneshot"]] == slot_of["retriever.range"]
        for n in ONESHOT[2:]:
            if n != "oneshot.wait":
                assert parent[slot_of[n]] == slot_of["fleet.oneshot"], n
        waits = [s for n, s in zip(names, slots) if n == "oneshot.wait"]
        under = [recs.name[recs.rows(parent[s])] for s in waits]
        assert under == ["oneshot.filter", "oneshot.fetch"]
    assert recs.rid[order[0]] != recs.rid[order[len(ONESHOT)]]


@pytest.mark.parametrize("dist", ["levenshtein", "erp"])
def test_fleet_build_spans(dist, tracer):
    t = time.monotonic_ns()
    _fleet(dist)
    wall = time.monotonic_ns() - t
    r = spans.records()
    build, flat = _by_name(r, "refnet.build"), _by_name(r, "refnet.flatten")
    assert len(build) == len(flat) == len(WORKERS)
    evals = _by_name(r, "counter.eval")
    under = r.name[r.rows(r.parent[evals])]
    assert set(under) <= {"refnet.build", "refnet.flatten"}
    assert "refnet.build" in set(under)
    for b in build:     # every build holds some evaluation
        assert (r.parent[evals] == r.slot[b]).any()
    plan = r.self_ns(children=("counter.eval",))[
        np.concatenate([build, flat])].sum()
    assert 0 < plan <= wall
    assert plan <= r.dur_ns[np.concatenate([build, flat])].sum()
