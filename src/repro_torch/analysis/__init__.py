"""Substrate invariant linter — AST passes over ``src/repro_torch``.

The reference package's linter (``repro.analysis``) as the port's own:
four passes, with the reference's rule ids, keep the architecture rules
machine-checked in the port (see ``docs/architecture.md`` § "Substrate
invariants"):

=================  ========================================================
pass               invariant
=================  ========================================================
``dispatch``       no per-item device dispatch inside loops
``accounting``     every distance is counted; padding rows never are
``sentinel``       BIG quasi-infinity arithmetic is always clamped
``shims``          deprecation shims warn and document v0.2 removal
=================  ========================================================

The reference's ``trace`` pass (the ``jax.jit`` trace cache) and its
``dispatch-jit-in-loop`` rule have no counterpart: the port runs no
``jax.jit``.

CLI: ``python tools/lint_torch.py [--format=json] [--root src/repro_torch]``.
"""

from repro_torch.analysis.core import (Finding, Module,  # noqa: F401
                                       pass_names, register, render_human,
                                       run, to_json)
