"""``BENCHMARK.json`` against the contract's shape, and discovery by name:
every name it gives finds its file, and an unknown name is refused."""

import json
import re

import pytest

from perfbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        moved = {m["moves"] for m in SPEC["per_layer"]
                 if w["name"] in m["workloads"]}
        reported = {m["name"] for m in SPEC["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        assert moved and moved <= reported
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = harness.load_json("configs", c["name"])
    assert c["file"] == f"perfbench/configs/{c['name']}.json"
    assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    harness.load_module("references", cfg["reference"])
    harness.load_module("datasets", cfg["dataset"])


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_name_finds_its_files(w):
    cell = harness.load_json("cells", w["name"])
    assert cell["why"] == w["why"]
    harness.load_module("drivers", cell["driver"])
    for trace in (False, True):
        for m in harness.metrics_for(SPEC, w["name"], trace):
            assert callable(harness.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("kind, name", [
    ("configs", "no-such-config"), ("cells", "protein-lev.nothing"),
    ("drivers", "open_loop2"), ("metrics", "p99_ms"),
    ("references", "dtw"), ("datasets", "songs"),
    ("metrics", "../run"), ("cells", "a/b"), ("drivers", "")])
def test_unknown_names_are_refused(kind, name):
    with pytest.raises(LookupError):
        if kind in ("configs", "cells"):
            harness.load_json(kind, name)
        else:
            harness.load_module(kind, name)
    with pytest.raises(LookupError):
        harness.workload(SPEC, "no-such-cell")
