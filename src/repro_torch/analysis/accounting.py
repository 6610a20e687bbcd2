"""accounting-soundness pass — every distance is counted, padding never is.

The paper's pruning-ratio currency (``evals_frac`` etc.) is only meaningful
if every evaluated distance flows through an accounting point:
``CountedDistance`` (the counter buckets), ``DispatchStats`` (the packed
dispatcher tallies rows/dispatches/LB tiers), or a shard's
``device_stats``.  A call site that grabs a :class:`KernelSpec` and calls
``.batch``/``.device_call`` raw — or reduces a padded array without
slicing back to the true row count — silently corrupts the counts the CI
baselines gate.

Rules
-----
``acct-raw-kernel-call``
    ``.device_call(...)``/``.batch(...)`` on a spec obtained from the
    kernel registry (or a raw ``np_backend.batch_for`` callable) outside
    the accounting-owner modules: ``core/counter.py`` (the counter),
    ``kernels/dispatch.py`` (tallies ``DispatchStats``),
    ``kernels/registry.py`` (the substrate itself),
    ``core/distributed.py`` (returns device stats to the elastic layer),
    and ``distances/np_backend.py`` (the oracle backend's own internals).
``acct-padded-slice``
    A reduction (``.sum()``/``np.sum``/``count_nonzero``/``.mean()``) over
    a name bound from a padding helper (``pad_ragged_rows``/``_pad_rows``/
    ``_pad_batch``/``np.pad``) with no interposed slice: the padding rows
    are counted as if they were data.  Slice with the ``PackedMeta`` row
    count (or the pre-pad batch size) first.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from repro_torch.analysis.core import (Finding, Module, call_terminal,
                                      dotted, module_functions, register)

#: modules that own an accounting point (see module docstring)
ACCT_OWNERS = ("core/counter.py", "kernels/dispatch.py",
               "kernels/registry.py", "core/distributed.py",
               "distances/np_backend.py")

#: registry getters whose result is a KernelSpec (or raw batch callable)
SPEC_GETTERS = {"get", "get_envelope", "spec_for_mode", "batch_for"}
RAW_CALLS = {"device_call", "batch"}

PAD_HELPERS = {"pad_ragged_rows", "_pad_rows", "_pad_batch", "pad"}
REDUCTIONS = {"sum", "mean", "count_nonzero", "nonzero", "prod"}


def _is_spec_getter(call: ast.Call) -> bool:
    name = call_terminal(call)
    if name not in SPEC_GETTERS:
        return False
    if name == "get":
        # disambiguate from dict.get / the models config registry: require
        # a receiver chain mentioning a kernel registry
        root = dotted(call.func) or ""
        return "registry" in root.split(".")[0] or \
            root.startswith("kernel_registry")
    return True


@register("accounting")
def check(mod: Module) -> List[Finding]:
    out: List[Finding] = []
    if not mod.rel.endswith(ACCT_OWNERS):
        out.extend(_raw_kernel_calls(mod))
    out.extend(_padded_reductions(mod))
    return out


def _raw_kernel_calls(mod: Module) -> List[Finding]:
    # the module tree and each def are scanned with their own local spec
    # bindings; a call visible from both scans is reported once
    found: List[Finding] = []
    reported: set = set()
    for func in [mod.tree] + module_functions(mod.tree):
        specs: Set[str] = set()
        for node in ast.walk(func):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not func:
                continue
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _is_spec_getter(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        specs.add(t.id)
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            flagged = None
            if isinstance(f, ast.Attribute) and f.attr in RAW_CALLS:
                if isinstance(f.value, ast.Name) and f.value.id in specs:
                    flagged = f"{f.value.id}.{f.attr}"
                elif isinstance(f.value, ast.Call) and \
                        _is_spec_getter(f.value):
                    flagged = f"<registry getter>.{f.attr}"
            elif isinstance(f, ast.Name) and f.id in specs:
                flagged = f.id
            if flagged and id(node) not in reported:
                reported.add(id(node))
                found.append(Finding(
                    mod.rel, node.lineno, "acct-raw-kernel-call",
                    f"raw kernel call '{flagged}(...)' bypasses "
                    "CountedDistance / DispatchStats accounting; route "
                    "through the counter or the packed dispatcher"))
    return found


def _padded_reductions(mod: Module) -> List[Finding]:
    out: List[Finding] = []
    for func in module_functions(mod.tree):
        padded: Dict[str, int] = {}
        sliced: Set[str] = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    call_terminal(node.value) in PAD_HELPERS:
                for t in node.targets:
                    # pad helpers return the padded array either bare or
                    # first in a (padded, lens) tuple
                    if isinstance(t, ast.Tuple) and t.elts:
                        t = t.elts[0]
                    if isinstance(t, ast.Name):
                        padded[t.id] = node.lineno
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.value, ast.Name):
                sliced.add(node.value.id)
        if not padded:
            continue
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            name = call_terminal(node)
            if name not in REDUCTIONS:
                continue
            # receiver (x.sum()) or first arg (np.sum(x)) is a padded name
            cand = None
            if isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name):
                cand = node.func.value.id
            elif node.args and isinstance(node.args[0], ast.Name):
                cand = node.args[0].id
            if cand in padded and cand not in sliced:
                out.append(Finding(
                    mod.rel, node.lineno, "acct-padded-slice",
                    f"reduction over padded array '{cand}' (padded at "
                    f"line {padded[cand]}) without slicing back to the "
                    "true row count: padding rows are being counted"))
    return out
