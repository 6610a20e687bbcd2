"""The harness: finds a cell's configuration, traffic, driver, reference
and metric readers by the names in ``BENCHMARK.json``, builds the cell's
fleet through the program's facade, hands it to the driver, checks the
answers against the plain reference and reads the metrics.

:func:`run_cell` is the whole of a run but the look for a card and the
check of loaded modules, which ``perfbench/run.py`` adds; the CPU
rehearsals in ``perfbench/tests`` call it with ``device="cpu"`` and small
``overrides``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import re
import sys
import time
import types
from typing import Callable, List, Optional

from perfbench import check, traffic

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: a traced run measures at most this long a window: the profiler's trace
#: of a longer one is hundreds of megabytes
TRACE_SECONDS = 10.0


def use_source_tree() -> None:
    """Put the program's sources (``src/``) and the checkout's root on
    the import path, as every command of the benchmark runs from a
    checkout with nothing installed."""
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole (``repro_torch`` passes)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def _path(kind: str, name: str, suffix: str) -> pathlib.Path:
    if not isinstance(name, str) or not NAME.match(name):
        raise LookupError(f"bad {kind} name {name!r}")
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise LookupError(f"no {kind} named {name!r} "
                          f"(looked for perfbench/{kind}/{name}{suffix})")
    return path


def load_json(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json``; refuses a name it does not find."""
    return json.loads(_path(kind, name, ".json").read_text())


def load_module(kind: str, name: str) -> types.ModuleType:
    """``perfbench/<kind>/<name>.py`` (names may hold dots and dashes, so
    it is loaded from its file); refuses a name it does not find."""
    path = _path(kind, name, ".py")
    mod_name = f"perfbench.{kind}._{re.sub(r'[.-]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_spec(path: Optional[pathlib.Path] = None) -> dict:
    return json.loads((path or REPO / "BENCHMARK.json").read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise LookupError(f"no workload named {name!r} in BENCHMARK.json")


def metrics_for(spec: dict, name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


class Run(types.SimpleNamespace):
    """Everything one run knows; drivers fill it, metric readers read it
    (``getattr(run, key, None)`` for what a driver may not set)."""

    def stream(self, name: str) -> int:
        return traffic.stream_seed(self.seed, name)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def retrieval_config(config: dict, device: str):
    """The program's ``RetrievalConfig`` for a configuration's file."""
    from repro_torch.retrieval import RetrievalConfig
    net = config["refnet"]
    return RetrievalConfig(
        config["distance"], execution="fleet", workers=config["workers"],
        eps_prime=net["eps_prime"], tight_bounds=net["tight_bounds"],
        max_cohort=net["max_cohort"], lb_cascade=net["lb_cascade"],
        serve_max_inflight=config["serve_max_inflight"], device=device)


def make_run(name: str, seed: int, seconds: float, trace: bool = False, *,
             device: str = "cuda", t_start: Optional[float] = None,
             spec: Optional[dict] = None,
             overrides: Optional[dict] = None) -> Run:
    """A run of cell ``name`` with its files found, its database made and
    its traffic planned from ``seed``; nothing of the program runs yet.
    ``overrides`` (``{"config": {...}, "cell": {...}}``) shrinks a cell for
    a CPU rehearsal."""
    import torch
    t0 = time.monotonic() if t_start is None else t_start
    spec = spec or load_spec()
    work = workload(spec, name)
    overrides = overrides or {}
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    config = {**load_json("configs", work["config"]),
              **overrides.get("config", {})}
    cell = {**load_json("cells", name), **overrides.get("cell", {})}
    wanted = metrics_for(spec, name, trace)
    run = Run(name=name, seed=seed, seconds=seconds, trace=trace,
              config=config, cell=cell, device=device, t0=t0,
              on_device=torch.device(device).type == "cuda",
              driver=load_module("drivers", cell["driver"]),
              ref=load_module("references", config["reference"]),
              wanted=wanted,
              readers={m["name"]: load_module("metrics", m["name"])
                       for m in wanted})
    dataset = load_module("datasets", config["dataset"])
    run.data = dataset.generate(config["windows"], config["window_length"],
                                run.stream("data"),
                                **config.get("dataset_args", {}))
    run.driver.plan(run)
    return run


def build(run: Run, log=_log) -> None:
    """Load the kernel's library and build the cell's fleet through the
    program's facade, on the host's clock.  The build is never profiled,
    also in a traced run: the profiler's cost per host-side op would count
    in the build's time."""
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.retrieval import Retriever
    if run.on_device:
        kbuild.load("wavefront")     # the .so from the checkout's cache
        torch.cuda.init()
    rcfg = retrieval_config(run.config, run.device)
    a = time.monotonic()
    run.retriever = Retriever.build(rcfg, run.data)
    if run.on_device:
        torch.cuda.synchronize()
    run.build_s = time.monotonic() - a
    run.build_evals = run.retriever.eval_stats()["build"]
    log(f"[perfbench] {run.name}: built {len(run.data)} windows on "
        f"{run.config['workers']} workers in {run.build_s:.3f} s")


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             spec: Optional[dict] = None, overrides: Optional[dict] = None,
             fault: Optional[Callable] = None, log=_log) -> dict:
    """One run of cell ``name``: returns the result line's object.
    ``fault(run)``, called after the warm-up, may break the program
    underneath to show that ``correct`` falls."""
    import torch
    from perfbench import trace as tr
    from repro_torch.kernels import wavefront as wf
    run = make_run(name, seed, seconds, trace, device=device,
                   t_start=t_start, spec=spec, overrides=overrides)
    driver, cell = run.driver, run.cell
    build(run, log)
    with tr.Launches(wf) as launches:
        run.launches = launches
        driver.warm(run)
        if fault is not None:
            fault(run)
        gc.collect()    # the build's garbage, collected before the window
        if run.on_device:
            torch.cuda.synchronize()
        if trace:
            with tr.profiled(torch, run.on_device) as box:
                launches.on = True
                driver.window(run)
                launches.on = False
            run.trace = box[0]
        else:
            driver.window(run)
    if run.on_device:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if run.on_device else 0
    # the program's state goes before the reference runs on the card
    run.retriever = None
    gc.collect()
    if run.on_device:
        torch.cuda.empty_cache()

    queries, answers = driver.checked(run)
    t = time.monotonic()
    expected = check.reference_hits(run.ref, queries, run.data, cell["eps"],
                                     device)
    got = check.compare(answers, expected)
    # a batch that failed leaves no answer in the sample: count it here
    got["unanswered_queries"] = max(got["unanswered_queries"], run.failed)
    log(f"[perfbench] reference: {got['compared']} queries, "
        f"{got['reference_hits']} hits, {got['missed_hits']} missed and "
        f"{got['added_hits']} added by the program, "
        f"{time.monotonic() - t:.2f} s")

    metrics = {}
    for m in run.wanted:
        value = run.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = got["compared"] > 0 and all(
        got[k] <= limit for k, limit in check.LIMITS.items())
    dev = {"platform": "gpu" if run.on_device else "cpu",
           "kind": torch.cuda.get_device_name(0) if run.on_device else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace:
        lo, hi = run.trace.span("perfbench.window") or (0.0, 0.0)
        dev["busy_s"] = run.trace.busy_in(lo, hi)
        dev["window_s"] = hi - lo
        out["breakdown"] = {"device_ops": run.trace.top_ops(lo, hi),
                            "idle_gaps": run.trace.idle_gaps(lo, hi)}
    out["checks"] = {k: {"value": got[k], "limit": limit}
                     for k, limit in check.LIMITS.items()}
    return out


def check_lines(result: dict) -> List[str]:
    """The compared numbers beside their limits, one line each."""
    return [f"check {k} = {v['value']} (limit {v['limit']})"
            for k, v in result["checks"].items()]
