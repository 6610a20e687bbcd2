"""The program's spans on the device trace's clock
(``perfbench/metrics/spans.py``), on a synthetic trace: idle split by the
innermost span, the parts summing to the window's idle, the readers'
per-batch arithmetic, the build's plan time, and no reading when the
anchor drifts by more than a millisecond."""

import numpy as np
import pytest

from perfbench import harness
from perfbench.metrics import spans as ps
from perfbench.trace import Trace

program_spans = pytest.importorskip("repro_torch.spans")

#: the monotonic clock's reading at the window's start, and the trace's
T_WINDOW = 5000.0
TRACE_T0 = 123.0
MS = 1e-3


def _event(cat, name, a_ms, b_ms):
    return {"ph": "X", "cat": cat, "name": name,
            "ts": (TRACE_T0 + a_ms * MS) * 1e6, "dur": (b_ms - a_ms) * 1e3}


def _trace(window_ms=100.0):
    return Trace([
        _event("user_annotation", "perfbench.window", 0.0, window_ms),
        _event("user_annotation", "perfbench.batch", 10.0, 50.0),
        _event("user_annotation", "perfbench.batch", 55.0, 95.0),
        _event("kernel", "wavefront_row_kernel", 20.0, 30.0),
        _event("gpu_memcpy", "Memcpy DtoH", 60.0, 70.0),
    ])


#: (name, parent row or -1, start ms, end ms) on the program's clock
SPANS = [("retriever.range", -1, 12.0, 48.0),
         ("oneshot.pivots", 0, 15.0, 35.0),
         ("oneshot.wait", 1, 25.0, 33.0),
         ("fleet.map_hits", 0, 36.0, 46.0),
         ("python.gc", 3, 40.0, 42.0),
         ("python.gc", -1, 50.0, 52.0),
         ("refnet.build", -1, -900.0, -800.0),
         ("counter.eval", 6, -890.0, -870.0),
         ("counter.eval", 6, -860.0, -850.0),
         ("python.gc", 6, -840.0, -839.0),
         ("refnet.flatten", -1, -790.0, -770.0),
         ("counter.eval", 10, -785.0, -780.0)]


def _records(spans=SPANS):
    slot = np.arange(len(spans)) * 2          # slots need not be dense
    ns = [(round((T_WINDOW + a * MS) * 1e9), round((T_WINDOW + b * MS) * 1e9))
          for _, _, a, b in spans]
    return program_spans.Records(
        slot=slot, name=np.asarray([s[0] for s in spans], object),
        start_ns=np.asarray([a for a, _ in ns], np.int64),
        end_ns=np.asarray([b for _, b in ns], np.int64),
        parent=np.asarray([slot[p] if p >= 0 else -1
                           for _, p, _, _ in spans], np.int64),
        rid=np.zeros(len(spans), np.int64))


def test_idle_goes_to_the_innermost_span():
    att = ps.attribute(_trace(), _records(), T_WINDOW, 100.0 * MS)
    got = {k: v / MS for k, v in att["by_name"].items()}
    # the window idles 80 of its 100 ms: [20, 30] and [60, 70] are busy
    assert att["idle"] / MS == pytest.approx(80.0)
    assert got["oneshot.wait"] == pytest.approx(3.0)       # [30, 33]
    assert got["oneshot.pivots"] == pytest.approx(7.0)     # 10 - its wait
    assert got["fleet.map_hits"] == pytest.approx(8.0)     # 10 - a pause
    assert got["python.gc"] == pytest.approx(4.0)          # 2 + 2
    assert got["retriever.range"] == pytest.approx(6.0)    # 26 - 10 - 10
    assert got["refnet.build"] == got["counter.eval"] == 0.0
    assert att["outside"] / MS == pytest.approx(52.0)
    layers = {k: ps.layer_s(att, k) / MS for k in ps.LAYERS}
    assert layers == pytest.approx({"oneshot": 10.0, "fleet": 8.0,
                                    "facade": 6.0, "gc": 4.0})
    assert sum(att["by_name"].values()) + att["outside"] \
        == pytest.approx(att["idle"], abs=1e-12)
    # 60 ms idle inside the batch ranges, 26 of it under retriever.range
    # (the pause at [50, 52] lies between two batches)
    assert att["batch_idle"] / MS == pytest.approx(60.0)
    assert att["batch_covered"] / MS == pytest.approx(26.0)
    assert att["wait"] / MS == pytest.approx(8.0)
    assert att["wait_by_phase"] == pytest.approx({"oneshot.pivots": 3 * MS})
    assert att["records"] == 6 and att["drift"] == pytest.approx(0.0)


@pytest.mark.parametrize("shift_ms", [-7.0, 0.0, 13.5])
def test_the_anchor_makes_the_clocks_offset_free(shift_ms):
    base = ps.attribute(_trace(), _records(), T_WINDOW, 100.0 * MS)
    moved = [(n, p, a + shift_ms, b + shift_ms) for n, p, a, b in SPANS]
    att = ps.attribute(_trace(), _records(moved),
                       T_WINDOW + shift_ms * MS, 100.0 * MS)
    assert att["by_name"] == pytest.approx(base["by_name"], abs=1e-9)
    assert att["outside"] == pytest.approx(base["outside"], abs=1e-9)


@pytest.mark.parametrize("elapsed_ms, read", [
    (100.0, True), (99.1, True), (100.9, True), (98.9, False),
    (101.2, False)])
def test_no_reading_when_the_anchor_drifts(elapsed_ms, read):
    att = ps.attribute(_trace(), _records(), T_WINDOW, elapsed_ms * MS)
    assert (att is not None) == read


def test_no_reading_without_a_window():
    tr = Trace([_event("kernel", "k", 0.0, 1.0)])
    assert ps.attribute(tr, _records(), T_WINDOW, 1.0) is None


def _run(**kw):
    base = dict(trace=_trace(), t_window=T_WINDOW, elapsed=100.0 * MS,
                batches=2, t0=T_WINDOW - 1.0, build_s=0.5)
    return harness.Run(**{**base, **kw})


READERS = ("oneshot_idle_ms.batch", "oneshot_wait_ms.batch",
           "fleet_idle_ms.batch", "facade_idle_ms.batch", "gc_idle_ms.batch",
           "build_plan_s")


def test_readers_per_batch(monkeypatch):
    monkeypatch.setattr(program_spans, "records", _records)
    run = _run()
    got = {m: harness.load_module("metrics", m).read(run) for m in READERS}
    assert got == pytest.approx({
        "oneshot_idle_ms.batch": 5.0, "oneshot_wait_ms.batch": 4.0,
        "fleet_idle_ms.batch": 4.0, "facade_idle_ms.batch": 3.0,
        "gc_idle_ms.batch": 2.0,
        # build: 100 - 30 of evaluation (its pause is plan code);
        # flatten: 20 - 5
        "build_plan_s": 85.0 * MS})
    drifted = _run(elapsed=95.0 * MS)
    for m in READERS[:-1]:      # the build's reading needs no trace
        assert harness.load_module("metrics", m).read(drifted) is None


def test_build_plan_counts_only_this_runs_build():
    recs = _records()
    # a build that ended before this run's start is another run's
    assert ps.build_plan_s(recs, round((T_WINDOW - 0.85) * 1e9),
                           round(T_WINDOW * 1e9)) == pytest.approx(15.0 * MS)
    assert ps.build_plan_s(recs, 0, round(T_WINDOW * 1e9)) \
        == pytest.approx(85.0 * MS)


def test_no_reading_past_the_tracers_capacity(monkeypatch):
    full = _records()
    full.overflow = 3
    monkeypatch.setattr(program_spans, "records", lambda: full)
    run = _run()
    for m in ("oneshot_idle_ms.batch", "build_plan_s"):
        assert harness.load_module("metrics", m).read(run) is None


def test_no_reading_from_a_program_without_the_tracer(monkeypatch):
    """The parent of the change that added the tracer has no
    ``repro_torch.spans``: every reader returns ``None``, none raises."""
    monkeypatch.setattr(ps, "program_spans", None)
    run = _run()
    for m in READERS:
        assert harness.load_module("metrics", m).read(run) is None
