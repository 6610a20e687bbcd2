"""dispatch-discipline pass — no per-item device dispatch inside loops.

The whole packed-dispatch substrate exists so that retrieval never pays
one backend dispatch per segment/candidate/shard: plans yield frontiers,
the engine merges them, and each merged round is ONE packed call.  A new
call site that loops ``Distance.batch`` / ``KernelSpec.device_call`` /
``dispatch.packed_batch`` / ``CountedDistance.eval_stacked`` (or a
per-query ``range_query``) inside a ``for``/``while`` body silently
reintroduces the antipattern — until a bench baseline catches the
dispatch-count rise.  This pass catches it at lint time.

Rule
----
``dispatch-in-loop``
    A call whose terminal name is a dispatch entry point executes once per
    loop iteration, outside the whitelisted engine drivers
    (``core/batch_engine.py`` drives frontiers by contract;
    ``core/counter.py`` owns the backend dispatch itself).

The reference's ``dispatch-jit-in-loop`` has no counterpart: the port
binds no ``jax.jit`` callables (its kernels are launched through their
wrappers, which ``DISPATCH_NAMES`` covers).
"""

from __future__ import annotations

from typing import List

from repro_torch.analysis.core import (Finding, Module, call_terminal,
                                      calls_in_loops, module_functions,
                                      register)

#: terminal callable names that are device/batched dispatch entry points
DISPATCH_NAMES = {"batch", "device_call", "packed_batch", "packed_envelope",
                  "eval_stacked", "range_query"}

#: modules allowed to drive dispatch from loops: the batch engine IS the
#: loop the substrate sanctions (one packed dispatch per merged round), the
#: counter owns the backend call under it, and the serve engine's tick loop
#: drives the batch engine (one shared round per tick)
ENGINE_DRIVERS = ("core/batch_engine.py", "core/counter.py",
                  "serve/engine.py")


@register("dispatch")
def check(mod: Module) -> List[Finding]:
    if mod.rel.endswith(ENGINE_DRIVERS):
        return []
    out: List[Finding] = []
    for func in [mod.tree] + module_functions(mod.tree):
        for call in calls_in_loops(func):
            name = call_terminal(call)
            if name in DISPATCH_NAMES:
                out.append(Finding(
                    mod.rel, call.lineno, "dispatch-in-loop",
                    f"'{name}(...)' runs once per loop iteration; batch "
                    "the items and dispatch once (engine round / packed "
                    "call), or drive through core/batch_engine"))
    # module-level statements double as function bodies above via mod.tree;
    # dedupe (a call can appear under both the module walk and a def walk)
    seen = set()
    uniq = []
    for f in out:
        key = (f.line, f.rule, f.message)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq
