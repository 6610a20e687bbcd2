"""The control of ``correct`` at a size a test run holds: the reference
put in the program's place as each reference module's ``CONTROL`` states
(ERP in bfloat16; Levenshtein with the boundary ``d < eps``) fails the
comparison on every seed tried, while the exact reference passes it."""

import pytest

from perfbench import control, harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SMALL = {"config": {"windows": 1500},
         "cell": {"pool_batches": 4, "sample_queries": 128}}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 3, 99])
def test_control_fails(name, seed):
    got = control.control_reading(name, seed, 8.0, "cpu", overrides=SMALL)
    assert got["compared"] >= 50
    assert got["mismatched_queries"] > 0, got


def test_exact_reference_passes_itself():
    from perfbench import check
    run = harness.make_run(CELLS[0], 5, 4.0, device="cpu", overrides=SMALL)
    qs = run.driver.control_queries(run)
    exact = check.reference_hits(run.ref, qs, run.data, run.cell["eps"],
                                 "cpu")
    assert check.compare([list(h) for h in exact], exact)[
        "mismatched_queries"] == 0
