"""The port's spans beside the card's kernels (``gpu`` marker; skipped
without a card).  Imports only the port, so it runs on a machine without
JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_spans_gpu.py

A small fleet's one-shot query runs under ``torch.profiler`` with the
tracer on.  Every program span shows in the profiler's events under its
name, at the tracer's own start once the two clocks are aligned by one
anchor range, and each wavefront kernel starts after the
``oneshot.pivots`` or ``oneshot.survivors`` span that launched it.
"""

import json
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.data.synthetic import proteins  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

#: the most a span's profiler range may start away from its aligned
#: record: a range opens just before the tracer reads the clock
ALIGN_S = 200e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_spans_line_up_with_the_kernels(cuda_device, tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    data = proteins(2000, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r = Retriever.build(RetrievalConfig(
            "levenshtein", execution="fleet", workers=["a", "b", "c", "d"],
            device="cuda"), data)
    rng = np.random.default_rng(5)
    qs = data[rng.integers(0, len(data), 32)].copy()
    flips = rng.random(qs.shape) < 0.1
    qs[flips] = rng.integers(0, int(data.max()) + 1, flips.sum())

    def answer():
        return r.batch(qs).via("fleet-oneshot").range(2.0).hits

    want = answer()                         # warm, tracer off
    with record_function("warm"):           # the first range's lookup
        pass
    spans.reset()
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("test.anchor"):
                t_anchor = time.monotonic_ns()
                got = [answer(), answer()]
            torch.cuda.synchronize()
        recs = spans.records()
    finally:
        spans.disable()
        spans.reset()
    assert got == [want, want]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    # host-side ranges (the profiler mirrors a range on the card's
    # timeline as a ``gpu_user_annotation`` too)
    host = [e for e in events
            if str(e.get("cat", "")).lower() in ("user_annotation", "cpu_op")]
    anchor = [e for e in host if e["name"] == "test.anchor"]
    assert len(anchor) == 1
    shift = anchor[0]["ts"] * 1e-6 - t_anchor * 1e-9
    start = recs.start_ns * 1e-9 + shift

    ranges = {}
    for e in host:
        ranges.setdefault(e["name"], []).append(e["ts"] * 1e-6)
    named = np.flatnonzero(recs.name != spans.GC)
    assert {"retriever.range", "fleet.oneshot", "oneshot.pivots",
            "oneshot.survivors", "oneshot.wait", "fleet.map_hits"} \
        <= set(recs.name[named])
    for i in named:
        near = np.abs(np.asarray(ranges.get(recs.name[i], [np.inf]))
                      - start[i])
        assert near.min() < ALIGN_S, (recs.name[i], near.min())

    kernels = sorted(e["ts"] * 1e-6 for e in events
                     if str(e.get("cat", "")).lower() == "kernel"
                     and "wavefront" in e["name"])
    launch = np.isin(recs.name, ["oneshot.pivots", "oneshot.survivors"])
    launchers = np.sort(start[launch])
    assert len(kernels) == len(launchers) == 4
    for k, (t, s) in enumerate(zip(kernels, launchers)):
        assert t > s, (k, t - s)
        if k + 1 < len(launchers):
            assert t < launchers[k + 1], k
