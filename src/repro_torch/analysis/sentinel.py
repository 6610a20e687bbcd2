"""sentinel-overflow pass — arithmetic on the ``BIG`` quasi-infinity.

The wavefront DP uses ``BIG = 3.4e37`` as a quasi-infinite cell value.
Adding or multiplying it without an interposed clamp runs off to float32
``inf`` within a few combines (``BIG + BIG`` overflows), and ``inf - x``
then poisons the fused-ε certificate with NaNs.  The DP clamps at
runtime with ``torch.clamp_max(new, BIG)`` after every combine (the
reference with ``jnp.minimum``); this pass is the static form of that
rule.

Rule
----
``sentinel-unclamped-arith``
    ``+``/``*`` with a ``BIG``-bound operand, or ``sum``/``cumsum`` over
    one, anywhere in the statement that is not under a ``minimum``/
    ``clip``/``clamp``/``clamp_max``/``min`` call.  ``BIG``-bound means: the literal
    name imported from ``kernels.wavefront``, a direct alias assignment
    (``INF = BIG``), or an attribute access ending ``.BIG``.
"""

from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.core import (Finding, Module, call_terminal,
                                      register)

CLAMPS = {"minimum", "clip", "clamp", "clamp_max", "min"}
SUMS = {"sum", "cumsum"}


def _big_names(mod: Module) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == "BIG":
                    names.add(alias.asname or alias.name)
        elif isinstance(node, ast.Assign):
            v = node.value
            if (isinstance(v, ast.Name) and v.id in names | {"BIG"}) or \
                    (isinstance(v, ast.Attribute) and v.attr == "BIG"):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
            elif isinstance(v, ast.Constant) and v.value == 3.4e37:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _is_big(node: ast.AST, names: Set[str]) -> bool:
    return (isinstance(node, ast.Name) and node.id in names) or \
        (isinstance(node, ast.Attribute) and node.attr == "BIG")


def _clamped(mod: Module, node: ast.AST) -> bool:
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.Call) and call_terminal(anc) in CLAMPS:
            return True
        if isinstance(anc, ast.stmt):
            return False
    return False


@register("sentinel")
def check(mod: Module) -> List[Finding]:
    names = _big_names(mod)
    if not names:
        return []
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.Add, ast.Mult)):
            if (_is_big(node.left, names) or _is_big(node.right, names)) \
                    and not _clamped(mod, node):
                out.append(Finding(
                    mod.rel, node.lineno, "sentinel-unclamped-arith",
                    "arithmetic on the BIG quasi-infinity without a "
                    "clamp: sums of sentinels overflow float32 to inf "
                    "(wrap in torch.clamp_max(..., BIG))"))
        elif isinstance(node, ast.Call) and call_terminal(node) in SUMS:
            if any(_is_big(a, names) for a in node.args) and \
                    not _clamped(mod, node):
                out.append(Finding(
                    mod.rel, node.lineno, "sentinel-unclamped-arith",
                    f"'{call_terminal(node)}' over a BIG-bound operand "
                    "without a clamp: cumulative sums of the sentinel "
                    "overflow float32"))
    return out
