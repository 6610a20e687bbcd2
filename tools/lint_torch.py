#!/usr/bin/env python
"""Substrate invariant linter CLI for the PyTorch/CUDA port.

  python tools/lint_torch.py                  # human output
  python tools/lint_torch.py --format=json    # machine-readable
  python tools/lint_torch.py --select dispatch,shims

``tools/lint.py``'s flags over ``src/repro_torch`` with the port's passes
(``repro_torch.analysis``; no JAX needed).

Exits 0 iff the tree is clean (no findings).  ``--max-pragmas`` bounds the
number of allowlist pragma comments in use (the acceptance budget: a tree
that needs many exemptions needs fixes, not pragmas).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import analysis  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default="src/repro_torch",
                    help="tree to lint (default: src/repro_torch)")
    ap.add_argument("--format", choices=("human", "json"), default="human")
    ap.add_argument("--select", default=None,
                    help="comma-separated subset of passes "
                         f"(default: all = {','.join(analysis.pass_names())})")
    ap.add_argument("--max-pragmas", type=int, default=10,
                    help="max allowlist pragma comments in use (default 10)")
    args = ap.parse_args()

    root = pathlib.Path(args.root)
    if not root.exists():
        print(f"error: no such lint root {root}", file=sys.stderr)
        return 2
    select = args.select.split(",") if args.select else None
    findings, stats = analysis.run(root, select=select)

    over_budget = stats["pragmas_used"] > args.max_pragmas
    if args.format == "json":
        print(analysis.to_json(findings, stats))
    else:
        print(analysis.render_human(findings, stats))
    if over_budget:
        print(f"error: {stats['pragmas_used']} allowlist pragmas in use "
              f"(budget: {args.max_pragmas}) — fix sites instead of "
              "suppressing them", file=sys.stderr)
    return 1 if (findings or over_budget) else 0


if __name__ == "__main__":
    sys.exit(main())
