"""Static-analysis core: pass registry, findings, allowlist pragmas.

The reference package's linter (``repro.analysis``) over the port: the
substrate invariants it checks (one packed dispatch per merged round,
padding rows never counted, BIG-sentinel clamping, deprecation-shim
hygiene) hold in ``src/repro_torch`` as they do in ``src/repro``.  Each
pass walks a module's AST and reports :class:`Finding`\\ s keyed by a stable
rule id (the reference's ids), and ``tools/lint_torch.py`` exits non-zero
when any survive.

Intentional exceptions are allowlisted in source with a pragma comment::

    # lint: allow[rule-id] -- why this site is exempt

placed on the flagged line or on the line directly above it.  The
justification text after ``--`` is mandatory: a pragma without one is
itself a finding (``pragma-missing-justification``), so suppressions stay
reviewable.  Several rules may share one pragma: ``allow[rule-a,rule-b]``.

Passes register themselves via :func:`register`; :func:`run` walks a tree,
parses each ``*.py`` once, runs every pass, and applies pragma
suppression.  Output shapes (human / JSON) live in :func:`render_human`
and :func:`to_json`.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence

#: ``# lint: allow[rule, rule2] -- justification``
PRAGMA_RE = re.compile(
    r"#\s*lint:\s*allow\[([A-Za-z0-9_\-, ]+)\]\s*(?:--\s*(\S.*))?")

#: rule id of the pragma-hygiene finding emitted by the runner itself
PRAGMA_RULE = "pragma-missing-justification"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""

    path: str          # path as given to run() (repo-relative in CI)
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Pragma:
    """One ``# lint: allow[...]`` comment."""

    line: int
    rules: tuple
    justification: str
    used: bool = False


@dataclasses.dataclass
class Module:
    """One parsed source file handed to every pass."""

    path: pathlib.Path
    rel: str                   # posix path relative to the lint root
    tree: ast.Module
    lines: List[str]
    pragmas: List[Pragma]
    _parents: Optional[Dict[ast.AST, ast.AST]] = None

    def parents(self) -> Dict[ast.AST, ast.AST]:
        """child node -> parent node map (built lazily, cached)."""
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        p = self.parents()
        while node in p:
            node = p[node]
            yield node


PassFn = Callable[[Module], List[Finding]]
_PASSES: Dict[str, PassFn] = {}


def register(name: str) -> Callable[[PassFn], PassFn]:
    def deco(fn: PassFn) -> PassFn:
        _PASSES[name] = fn
        return fn
    return deco


def load_default_passes() -> None:
    """Import the pass modules so their ``register`` calls run."""
    from repro_torch.analysis import (accounting, dispatch,  # noqa: F401
                                      sentinel, shims)


def pass_names() -> List[str]:
    load_default_passes()
    return sorted(_PASSES)


# -- shared AST helpers -------------------------------------------------------

def call_terminal(call: ast.Call) -> Optional[str]:
    """Terminal callable name of a Call: ``a.b.c(..)`` -> ``c``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" when the chain is pure Name/Attribute."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def loop_bodies(func: ast.AST) -> List[ast.AST]:
    """Every statement/expr subtree that re-executes per iteration inside
    ``func``: for/while bodies and comprehension elements (nested functions
    get their own scan, so their loops are not attributed to the parent)."""
    out: List[ast.AST] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, (ast.For, ast.AsyncFor, ast.While)):
                out.extend(child.body)
                out.extend(child.orelse)
            elif isinstance(child, (ast.ListComp, ast.SetComp, ast.DictComp,
                                    ast.GeneratorExp)):
                # the element/conditions run per iteration; the FIRST
                # generator's source iterable is evaluated exactly once
                if isinstance(child, ast.DictComp):
                    out.extend([child.key, child.value])
                else:
                    out.append(child.elt)
                for i, gen in enumerate(child.generators):
                    out.extend(gen.ifs)
                    if i > 0:
                        out.append(gen.iter)
            visit(child)

    visit(func)
    return out


def in_any(node: ast.AST, subtrees: Sequence[ast.AST]) -> bool:
    return any(node is t or any(node is n for n in ast.walk(t))
               for t in subtrees)


def calls_in_loops(func: ast.AST) -> List[ast.Call]:
    """All Call nodes that execute once per loop iteration in ``func``."""
    seen: List[ast.Call] = []
    for body in loop_bodies(func):
        for node in ast.walk(body):
            if isinstance(node, ast.Call) and node not in seen:
                seen.append(node)
    return seen


def module_functions(tree: ast.Module) -> List[ast.AST]:
    """Every function/method def in the module, including nested ones."""
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


# -- runner -------------------------------------------------------------------

def collect_pragmas(lines: Sequence[str]) -> List[Pragma]:
    out = []
    for i, text in enumerate(lines, start=1):
        m = PRAGMA_RE.search(text)
        if m:
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            out.append(Pragma(line=i, rules=rules,
                              justification=(m.group(2) or "").strip()))
    return out


def load_module(path: pathlib.Path, root: pathlib.Path) -> Module:
    text = path.read_text()
    try:
        rel = path.relative_to(root).as_posix()
    except ValueError:
        rel = path.as_posix()
    lines = text.splitlines()
    return Module(path=path, rel=rel, tree=ast.parse(text, str(path)),
                  lines=lines, pragmas=collect_pragmas(lines))


def _suppressed(f: Finding, pragmas: List[Pragma]) -> bool:
    for p in pragmas:
        if f.rule in p.rules and f.line in (p.line, p.line + 1):
            p.used = True
            return True
    return False


def run(root: pathlib.Path, *, select: Optional[Sequence[str]] = None,
        files: Optional[Sequence[pathlib.Path]] = None):
    """Lint every ``*.py`` under ``root`` (or just ``files``).

    Returns ``(findings, stats)`` where stats counts files, pragmas in use,
    and pragmas per rule (the acceptance budget is on pragma *comments*).
    """
    load_default_passes()
    root = pathlib.Path(root)
    names = list(select) if select else sorted(_PASSES)
    unknown = [n for n in names if n not in _PASSES]
    if unknown:
        raise KeyError(f"unknown pass(es) {unknown}; have {sorted(_PASSES)}")
    paths = sorted(files) if files else sorted(root.rglob("*.py"))

    findings: List[Finding] = []
    stats = {"files": 0, "passes": names, "pragmas_used": 0,
             "pragmas": []}
    for path in paths:
        try:
            mod = load_module(path, root)
        except SyntaxError as e:
            findings.append(Finding(str(path), e.lineno or 0, "parse-error",
                                    f"cannot parse: {e.msg}"))
            continue
        stats["files"] += 1
        raw: List[Finding] = []
        for name in names:
            raw.extend(_PASSES[name](mod))
        for f in raw:
            if not _suppressed(f, mod.pragmas):
                findings.append(f)
        for p in mod.pragmas:
            if p.used and not p.justification:
                findings.append(Finding(
                    mod.rel, p.line, PRAGMA_RULE,
                    "allowlist pragma needs a justification: "
                    "# lint: allow[rule] -- <why this site is exempt>"))
            if p.used:
                stats["pragmas_used"] += 1
                stats["pragmas"].append(
                    {"path": mod.rel, "line": p.line,
                     "rules": list(p.rules),
                     "justification": p.justification})
    return sorted(findings), stats


def to_json(findings: Sequence[Finding], stats: dict) -> str:
    return json.dumps({
        "findings": [f.to_dict() for f in findings],
        "clean": not findings,
        "stats": stats,
    }, indent=2)


def render_human(findings: Sequence[Finding], stats: dict) -> str:
    lines = [f.format() for f in findings]
    lines.append(f"# {len(findings)} finding(s) across {stats['files']} "
                 f"file(s); {stats['pragmas_used']} allowlist pragma(s) "
                 "in use")
    return "\n".join(lines)
