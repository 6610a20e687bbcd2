"""The control of ``correct``: the plain reference put in the program's
place, run as the reference module's ``CONTROL`` states (a lower precision,
or a broken guarantee), over the queries that a run of the cell compares,
and judged by the same comparison.  Its numbers are the upper readings the
limits are set below; the benchmark's own runs never run it.

    python3 -m perfbench.control --workload traj-erp.batch --seconds 51 \
        --seeds 101,102,103

Prints one JSON line per seed.  Runs on the card by default
(``--device cpu`` runs it on the host).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_reading(name: str, seed: int, seconds: float, device: str,
                    overrides=None) -> dict:
    """The compared numbers of the control for one seed of a cell."""
    from perfbench import check, harness
    run = harness.make_run(name, seed, seconds, device=device,
                           overrides=overrides)
    qs = run.driver.control_queries(run)
    eps = run.cell["eps"]
    t = time.monotonic()
    exact = check.reference_hits(run.ref, qs, run.data, eps, device)
    ctl = check.reference_hits(run.ref, qs, run.data, eps, device,
                               control=True)
    got = check.compare([list(h) for h in ctl], exact)
    got.update(workload=name, seed=seed, seconds=time.monotonic() - t)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from perfbench import harness
    harness.use_source_tree()
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(control_reading(args.workload, seed, args.seconds,
                                         args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
