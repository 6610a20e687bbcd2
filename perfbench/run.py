"""Measure one cell of ``BENCHMARK.json`` on the card.

    python3 -m perfbench.run --workload protein-lev.batch --seed 7 \
        --seconds 51 --trace 0

Prints progress and, last, each compared number beside its limit on
standard error, and one JSON object as the last line of standard output.
Without a CUDA card (or with fewer than the cell asks for) it exits 2 and
prints no result; it never falls back to the CPU.  It exits 3 and prints
no result if JAX or the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402 -- the clock starts before the imports
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# ``python3 perfbench/run.py`` finds the package from the checkout's root
_REPO = str(pathlib.Path(__file__).resolve().parents[1])
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return proc.stdout.strip() or proc.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc!r})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness
    harness.use_source_tree()
    spec = harness.load_spec()
    chips = harness.workload(spec, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"[perfbench] needs {chips} CUDA card(s); "
             f"is_available={torch.cuda.is_available()}, "
             f"device_count={torch.cuda.device_count()}")
        return 2
    _log(f"[perfbench] card: {_card_line()}")
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_PROCESS, spec=spec)
    bad = harness.forbidden_modules()
    if bad:
        _log(f"[perfbench] forbidden modules loaded: {bad}")
        return 3
    for line in harness.check_lines(result):
        _log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
