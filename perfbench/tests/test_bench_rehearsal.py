"""A tiny CPU rehearsal of each cell through ``harness.run_cell`` (the
whole run but the look for a card): the program's kernel runs as its
plain version, and the answers are held to the reference."""

import pytest

from perfbench import harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
#: a cell shrunk to seconds on the CPU; widths and traffic kinds unchanged
TINY = {"config": {"windows": 200},
        "cell": {"batch": 8, "pool_batches": 4, "warmup_batches": 1,
                 "sample_queries": 24}}


def rehearse(name, trace=False, fault=None, seed=2**31 + 17, tiny=TINY):
    return harness.run_cell(name, seed, 1.5, trace, device="cpu", spec=SPEC,
                            overrides=tiny, fault=fault, log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(name, trace):
    res = rehearse(name, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    got = set(res["metrics"])
    want = {m["name"] for m in harness.metrics_for(SPEC, name, trace)}
    if trace:
        # the profiler sees no device on the CPU: those metrics go out
        source = {m["name"]: m["source"] for m in SPEC["per_layer"]}
        assert got == {m for m in want if source[m] != "device_trace"}
        assert "breakdown" in res and res["device"]["window_s"] > 0
    else:
        assert got == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
