"""shim-discipline pass — deprecation shims warn and document removal.

The v0.1 -> facade migration left four sanctioned shims
(``SubsequenceMatcher``, ``ElasticIndex``, ``EmbeddingRetriever``,
``core.distributed._batch_dist``).  The contract, enforced here: a shim
must emit its warning through the ``core/_deprecation`` plumbing
(``warn_legacy``/``warn_moved`` — these respect ``facade_construction``
suppression), and its docstring must name BOTH the replacement entry
point and the removal release (v0.2), so callers reading help() get the
migration path.

Rules
-----
``shim-missing-warn``
    A def/class whose docstring declares it deprecated but whose body
    never calls ``warn_legacy``/``warn_moved``: external callers migrate
    blind.
``shim-docstring``
    A def/class that warns (or documents deprecation) without naming the
    v0.2 removal release and a ``repro_torch.``/facade replacement path in
    its docstring.
"""

from __future__ import annotations

import ast
import re
from typing import List

from repro_torch.analysis.core import (Finding, Module, call_terminal,
                                      module_functions, register)

WARN_CALLS = {"warn_legacy", "warn_moved"}
DEPRECATED_RE = re.compile(r"\bdeprecat", re.IGNORECASE)
REPLACEMENT_RE = re.compile(r"repro_torch\.|Retriever|facade")

#: the deprecation plumbing itself (its docstrings describe the mechanism)
SHIM_MACHINERY = ("core/_deprecation.py",)


def _warns(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and call_terminal(n) in WARN_CALLS
               for n in ast.walk(node))


@register("shims")
def check(mod: Module) -> List[Finding]:
    if mod.rel.endswith(SHIM_MACHINERY):
        return []
    out: List[Finding] = []
    defs: List[ast.AST] = list(module_functions(mod.tree))
    defs += [n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]
    audited_classes = set()
    for node in defs:
        if isinstance(node, ast.ClassDef):
            doc = ast.get_docstring(node) or ""
            if _warns(node) or DEPRECATED_RE.search(doc):
                audited_classes.add(node)
    for node in defs:
        doc = ast.get_docstring(node) or ""
        declared = bool(DEPRECATED_RE.search(doc))
        warns = _warns(node)
        if not declared and not warns:
            continue
        # methods of a shim class ride on the class-level docstring (the
        # class itself is audited) — don't re-audit each method that
        # carries the warn call
        if not declared and any(
                node in ast.walk(c) and node is not c
                for c in audited_classes):
            continue
        if declared and not warns:
            out.append(Finding(
                mod.rel, node.lineno, "shim-missing-warn",
                f"'{node.name}' documents itself as deprecated but never "
                "calls warn_legacy/warn_moved (core/_deprecation): "
                "external callers migrate blind"))
        if (declared or warns) and not (
                "v0.2" in doc and REPLACEMENT_RE.search(doc)):
            out.append(Finding(
                mod.rel, node.lineno, "shim-docstring",
                f"deprecation shim '{node.name}' must name the v0.2 "
                "removal release and the replacement entry point in its "
                "docstring"))
    return out
