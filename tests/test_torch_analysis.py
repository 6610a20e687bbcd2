"""The port's substrate linter (``repro_torch.analysis``) against the
reference's (``repro.analysis``), and the port's lint gate.

Every violation fixture of ``tests/test_analysis.py`` and its clean twin
go through both packages' passes and must give the same rule ids on the
same lines, for every rule the port keeps (the reference's ``trace-*`` and
``dispatch-jit-in-loop`` rules guard ``jax.jit`` and have no counterpart).
The pragma machinery is held the same way, and ``src/repro_torch`` must be
clean under both rule sets with at most :data:`PRAGMA_BUDGET` pragmas.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro import analysis as ref_analysis
from repro_torch import analysis
from repro_torch.analysis.core import PRAGMA_RULE

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

#: allowlist pragmas the port's tree may use (``tools/lint.py``'s default
#: budget); it uses 6: two per-query host loops of the facade, the
#: fleet's host parity loop, ``ops.wavefront``'s compatibility wrapper and
#: the matcher's two sequential references
PRAGMA_BUDGET = 10

#: rule ids of the port's passes
PORT_RULES = {"dispatch-in-loop", "acct-raw-kernel-call", "acct-padded-slice",
              "sentinel-unclamped-arith", "shim-missing-warn",
              "shim-docstring", PRAGMA_RULE}

#: (fixture id, passes, source): ``tests/test_analysis.py``'s fixtures
FIXTURES = [
    ("dispatch-loop", ["dispatch"], """
        def sweep(net, queries, eps):
            out = []
            for q in queries:
                out.append(net.range_query(q, eps))
            return out
        """),
    ("dispatch-comprehension", ["dispatch"], """
        def sweep(net, queries, eps):
            return [net.range_query(q, eps) for q in queries]
        """),
    ("dispatch-engine-clean", ["dispatch"], """
        def sweep(engine, net, queries, eps):
            plans = [net.range_query_plan(eps) for _ in queries]
            return engine.run(plans, list(queries), eps)
        """),
    ("dispatch-iterable-source-clean", ["dispatch"], """
        def count(fleet, queries, eps):
            return sum(len(h) for h in fleet.batch(queries).range(eps))
        """),
    ("dispatch-jit-loop", ["dispatch"], """
        import jax

        def embed(model, rows):
            fwd = jax.jit(model.forward)
            return [fwd(r) for r in rows]
        """),
    ("acct-raw-call", ["accounting"], """
        from repro.kernels import registry

        def raw(xs, ys):
            spec = registry.get("levenshtein")
            return spec.batch(xs, ys)
        """),
    ("acct-counted-clean", ["accounting"], """
        def counted(counter, xs, ys):
            return counter.eval_batch(xs, ys, bucket="query")
        """),
    ("acct-padded", ["accounting"], """
        from repro.kernels.dispatch import pad_ragged_rows

        def total(rows):
            padded, lens = pad_ragged_rows(rows)
            return padded.sum()
        """),
    ("acct-padded-sliced-clean", ["accounting"], """
        from repro.kernels.dispatch import pad_ragged_rows

        def total(rows):
            padded, lens = pad_ragged_rows(rows)
            true = padded[: len(rows)]
            return true.sum()
        """),
    ("sentinel-unclamped", ["sentinel"], """
        from repro.distances._wavefront import BIG

        def bump(row):
            return row + BIG
        """),
    ("sentinel-clamped-clean", ["sentinel"], """
        import jax.numpy as jnp
        from repro.distances._wavefront import BIG

        def bump(row):
            return jnp.minimum(row + BIG, BIG)
        """),
    ("shim-missing-warn", ["shims"], """
        class OldThing:
            \"\"\"Deprecated; use repro.retrieval.Retriever. Removed in v0.2.\"\"\"

            def __init__(self):
                self.x = 1
        """),
    ("shim-missing-docstring", ["shims"], """
        from repro.core._deprecation import warn_legacy

        class OldThing:
            \"\"\"Deprecated thing.\"\"\"

            def __init__(self):
                warn_legacy("OldThing")
        """),
    ("shim-compliant-clean", ["shims"], """
        from repro.core._deprecation import warn_legacy

        class OldThing:
            \"\"\"Deprecated; use repro.retrieval.Retriever instead.

            This shim will be removed in v0.2.
            \"\"\"

            def __init__(self):
                warn_legacy("OldThing")
        """),
    ("pragma-justified", ["dispatch"], """
        def sweep(net, queries, eps):
            # lint: allow[dispatch-in-loop] -- sequential parity reference
            return [net.range_query(q, eps) for q in queries]
        """),
    ("pragma-unjustified", ["dispatch"], """
        def sweep(net, queries, eps):
            # lint: allow[dispatch-in-loop]
            return [net.range_query(q, eps) for q in queries]
        """),
    ("pragma-other-rule", ["dispatch"], """
        def sweep(net, queries, eps):
            # lint: allow[trace-host-branch] -- wrong rule entirely
            return [net.range_query(q, eps) for q in queries]
        """),
]

#: what the port's passes must report on each fixture
EXPECTED = {
    "dispatch-loop": ["dispatch-in-loop"],
    "dispatch-comprehension": ["dispatch-in-loop"],
    "dispatch-engine-clean": [],
    "dispatch-iterable-source-clean": [],
    "dispatch-jit-loop": [],
    "acct-raw-call": ["acct-raw-kernel-call"],
    "acct-counted-clean": [],
    "acct-padded": ["acct-padded-slice"],
    "acct-padded-sliced-clean": [],
    "sentinel-unclamped": ["sentinel-unclamped-arith"],
    "sentinel-clamped-clean": [],
    "shim-missing-warn": ["shim-missing-warn"],
    "shim-missing-docstring": ["shim-docstring"],
    "shim-compliant-clean": [],
    "pragma-justified": [],
    "pragma-unjustified": [PRAGMA_RULE],
    "pragma-other-rule": ["dispatch-in-loop"],
}


def _lint(pkg, tmp_path, source, select):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(source))
    findings, stats = pkg.run(tmp_path, select=select, files=[path])
    return [(f.rule, f.line) for f in findings], stats


@pytest.mark.parametrize("name,select,source", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_matches_reference(tmp_path, name, select, source):
    got, stats = _lint(analysis, tmp_path, source, select)
    ref, ref_stats = _lint(ref_analysis, tmp_path, source, select)
    assert got == [(r, ln) for r, ln in ref if r in PORT_RULES]
    assert [r for r, _ in got] == EXPECTED[name]
    assert stats["pragmas_used"] == ref_stats["pragmas_used"]
    assert stats["pragmas"] == ref_stats["pragmas"]


def test_jit_rule_is_the_only_difference(tmp_path):
    """The reference flags the jitted callable; the port has no such rule."""
    source = dict((f[0], f[2]) for f in FIXTURES)["dispatch-jit-loop"]
    ref, _ = _lint(ref_analysis, tmp_path, source, ["dispatch"])
    assert [r for r, _ in ref] == ["dispatch-jit-in-loop"]


def test_pragma_justification_is_recorded(tmp_path):
    source = dict((f[0], f[2]) for f in FIXTURES)["pragma-justified"]
    got, stats = _lint(analysis, tmp_path, source, ["dispatch"])
    assert got == []
    assert stats["pragmas_used"] == 1
    assert stats["pragmas"][0]["justification"] == \
        "sequential parity reference"


def test_sentinel_accepts_torch_clamp(tmp_path):
    """``torch.clamp_max`` clamps the sentinel as ``jnp.minimum`` does."""
    got, _ = _lint(analysis, tmp_path, """
        import torch
        from repro_torch.distances._wavefront import BIG

        def bump(row):
            return torch.clamp_max(row + BIG, BIG)
        """, ["sentinel"])
    assert got == []
    got, _ = _lint(analysis, tmp_path, """
        import torch
        from repro_torch.distances._wavefront import BIG

        def bump(row):
            return torch.abs(row + BIG)
        """, ["sentinel"])
    assert got == [("sentinel-unclamped-arith", 6)]


def test_shim_names_the_port_replacement(tmp_path):
    got, _ = _lint(analysis, tmp_path, """
        from repro_torch.core._deprecation import warn_moved

        def old(x):
            \"\"\"Deprecated since v0.1, removed in v0.2: call
            ``repro_torch.kernels.registry.get(name).batch``.\"\"\"
            warn_moved("old", "repro_torch.kernels.registry.get")
            return x
        """, ["shims"])
    assert got == []


def test_passes_and_unknown_selection(tmp_path):
    assert analysis.pass_names() == ["accounting", "dispatch", "sentinel",
                                     "shims"]
    (tmp_path / "m.py").write_text("x = 1\n")
    with pytest.raises(KeyError):
        analysis.run(tmp_path, select=["trace"])


def test_src_repro_torch_is_clean():
    findings, stats = analysis.run(PORT)
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)
    assert stats["pragmas_used"] <= PRAGMA_BUDGET, stats["pragmas"]
    for p in stats["pragmas"]:
        assert p["justification"], p


def test_reference_passes_find_src_repro_torch_clean():
    """The reference's own passes, apart from its jit-only rules."""
    findings, _ = ref_analysis.run(PORT)
    kept = [f for f in findings if not f.rule.startswith("trace-")
            and f.rule != "dispatch-jit-in-loop"]
    assert kept == [], "\n" + "\n".join(f.format() for f in kept)


def test_cli_exits_clean():
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "lint_torch.py"),
         "--format=json"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["clean"] is True
    assert payload["stats"]["passes"] == analysis.pass_names()
    assert payload["stats"]["pragmas_used"] <= PRAGMA_BUDGET


def test_cli_fails_on_a_finding(tmp_path):
    (tmp_path / "bad.py").write_text(textwrap.dedent("""
        def sweep(net, queries, eps):
            return [net.range_query(q, eps) for q in queries]
        """))
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "lint_torch.py"),
         "--root", str(tmp_path)], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1
    assert "[dispatch-in-loop]" in proc.stdout
