"""Dry-run of every (architecture x input shape x mesh) cell on ``meta``.

For each cell the step runs on a ``meta`` network (``launch/specs.py``):
training runs forward, backward and AdamW (``train_state.make_train_step``;
with ``remat="block"`` the blocks' recomputation in the backward pass is
counted), prefill runs ``forward(return_cache=True)``, decode runs
``decode_step`` over a ``meta`` cache of the shape's length.  Nothing is
allocated and no card is needed.  The step's matrix-product flops are
counted as it runs (``roofline.costs.count_flops``), once per (arch,
shape); for each mesh the record holds the per-device bytes of the
parameters, optimizer state, cache, batch and outputs (the specs' shard
shapes), whether they fit one H100, and the flops beside the model's
(``roofline.report.model_flops_for``).  Records go to
``reports/dryrun_torch/*.json``; resumable per cell.

On the production meshes (``pod16x16``, ``pod2x16x16``) the step also runs
partitioned, as the reference lowers it (:func:`partitioned`): under
``Ctx`` on a ``DeviceMesh`` of a ``fake`` process group of the mesh's
world size, as rank 0, with ``meta`` local shards, the parameters, batch,
cache and optimizer state laid out by their logical axes.  Nothing is
sent; ``roofline.costs.count_collectives`` counts the rank's local
matrix-product flops (``flops_per_device``; the even split ``flops /
n_devices`` stays beside it as ``flops_even_split``) and the operand bytes
of its collectives per kind (``collectives``, the reference's layout).
``h100x1`` runs no collective and keeps the unpartitioned record.  Memory
is the specs' per-device bytes (no temporaries).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k [--mesh h100x1] [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 8]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import pathlib
import time
import traceback
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import MESHES, Mesh, device_mesh
from repro_torch.models import registry
from repro_torch.models.layers import NOCTX, Ctx
from repro_torch.models.params import decay_mask, distribute, distribute_tree
from repro_torch.roofline import costs
from repro_torch.roofline.report import model_flops_for
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_state import make_train_step

REPORT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "reports"
              / "dryrun_torch")


def runnable(cfg, shape_name: str) -> bool:
    """long_500k needs sub-quadratic mixing (full attention at 524k
    positions is quadratic): SSM and hybrid only."""
    if shape_name == "long_500k":
        return cfg.sub_quadratic
    return True


def opt_config(cfg: ModelConfig) -> opt_lib.OptConfig:
    return opt_lib.OptConfig(state_dtype=specs_lib._moment_dtype(cfg))


def step_fn(cfg: ModelConfig, mod, kind: str, ctx: Ctx = NOCTX):
    """The cell's step as ``fn(net, inputs)``: ``inputs`` holds ``batch``,
    and ``opt`` (the optimizer state) for training or ``cache`` for
    decode; under ``ctx``'s mesh, partitioned."""
    if kind == "train":
        train_step = make_train_step(mod, cfg, opt_config(cfg), ctx)
        return lambda net, inp: train_step(net, inp["opt"], inp["batch"])
    if kind == "prefill":
        return lambda net, inp: mod.forward(net, inp["batch"], cfg, ctx,
                                            return_cache=True)
    return lambda net, inp: mod.decode_step(net, inp["cache"],
                                            inp["batch"]["tokens"], cfg, ctx)


def opt_state(cfg: ModelConfig, mod, net) -> dict:
    """AdamW's state for the trainable leaves of ``net`` (on its device),
    in the cell's moment dtype."""
    named = dict(net.named_parameters())
    return opt_lib.init_state(
        {k: named[k] for k in decay_mask(mod.param_defs(cfg))},
        opt_config(cfg))


def memory(cfg: ModelConfig, mod, shape: ShapeConfig, mesh_name: str,
           dtype: torch.dtype) -> Dict[str, int]:
    """Per-device bytes of a cell on a mesh: ``param``, ``opt``, ``cache``,
    ``batch`` (the step's arguments, summed as ``argument``) and
    ``output``: the arrays the step returns besides its arguments (training:
    AdamW's new moments, the parameters being written in place; prefill:
    the logits and the cache; decode: the logits)."""
    mesh = MESHES[mesh_name]
    tp = mesh.shape["model"]
    train = shape.kind == "train"
    rules = shd.TRAIN_RULES if train else shd.SERVE_RULES
    B, S = shape.global_batch, shape.seq_len
    mem = {"param_bytes": specs_lib.nbytes(specs_lib.param_specs(
        cfg, mod, mesh, rules, tp, dtype)),
        "opt_bytes": 0, "cache_bytes": 0,
        "batch_bytes": specs_lib.nbytes(specs_lib.batch_specs(
            cfg, shape, mesh, rules, dtype))}
    if train:
        osp = specs_lib.opt_specs(cfg, mod, mesh, rules, tp, getattr(
            torch, specs_lib._moment_dtype(cfg)))
        mem["opt_bytes"] = specs_lib.nbytes(osp)
        mem["output_bytes"] = specs_lib.nbytes({"m": osp["m"],
                                                "v": osp["v"]})
    elif shape.kind == "prefill":
        csp = specs_lib.cache_specs(cfg, mod, shape, mesh, rules, dtype)
        mem["output_bytes"] = specs_lib.logits_spec(
            cfg, B, S, mesh, rules, dtype).nbytes + sum(
            s.nbytes for s in csp.values()
            if s is not None and s.tensor.ndim)
    else:
        mem["cache_bytes"] = specs_lib.nbytes(specs_lib.cache_specs(
            cfg, mod, shape, mesh, rules, dtype))
        mem["output_bytes"] = specs_lib.logits_spec(
            cfg, B, 1, mesh, rules, dtype).nbytes
    mem["argument_bytes"] = (mem["param_bytes"] + mem["opt_bytes"]
                             + mem["cache_bytes"] + mem["batch_bytes"])
    return mem


def abstract_inputs(cfg: ModelConfig, mod, shape: ShapeConfig, net,
                    dtype: torch.dtype) -> dict:
    """The step's inputs on ``meta`` (their global shapes)."""
    mesh = MESHES["h100x1"]
    rules = shd.TRAIN_RULES if shape.kind == "train" else shd.SERVE_RULES
    inputs = {"batch": specs_lib.tensors(
        specs_lib.batch_specs(cfg, shape, mesh, rules, dtype))}
    if shape.kind == "train":
        inputs["opt"] = opt_state(cfg, mod, net)
    elif shape.kind == "decode":
        inputs["cache"] = specs_lib.tensors(
            specs_lib.cache_specs(cfg, mod, shape, mesh, rules, dtype))
    return inputs


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks, this
    process rank 0: collectives on ``meta`` tensors run their shape
    functions and send nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def program_mesh(mesh: Mesh) -> Mesh:
    """The mesh the partitioned program runs on: ``mesh``, with a ``pod``
    axis folded into ``data`` (``(2, 16, 16)`` runs as ``(32, 16)``).

    On the folded mesh the batch is split over the 32 ranks of ``(pod,
    data)`` in the reference's order, so a serving step is the
    reference's; a training step's FSDP split of the weights spans both
    pods (32 ways) where the reference's stays in one (16 ways, weights
    replicated across pods).  The fold is for time: ``DTensor``'s
    cost-based choice of each op's layout explores far more candidates on
    a 3-axis mesh whose batch is split over two axes (one reduced qwen3-4b
    decode step took 289 s to count on the CPU against 4.9 s on
    ``(16, 16)``)."""
    if "pod" not in mesh.axis_names:
        return mesh
    sizes = dict(zip(mesh.axis_names, mesh.sizes))
    return Mesh(("data", "model"), (sizes["pod"] * sizes["data"],
                                    sizes["model"]))


def partitioned(arch: str, shape: ShapeConfig, mesh_name: str, *,
                dtype: Optional[torch.dtype] = None, reduced: bool = False,
                **replace) -> dict:
    """The cell's step partitioned on ``mesh_name`` as one rank of a
    ``fake`` group sees it (module docstring), the config's fields
    ``replace``d (a cut in depth): ``{"flops_per_device", "collectives",
    "count_s"}``."""
    cfg, mod = registry.get(arch, reduced=reduced)
    cfg = dataclasses.replace(cfg, **replace)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    mesh = program_mesh(MESHES[mesh_name])
    rules = shd.TRAIN_RULES if shape.kind == "train" else shd.SERVE_RULES
    t0 = time.perf_counter()
    with fake_group(mesh.n_devices):
        dmesh = device_mesh(mesh, "cuda")
        ctx = Ctx(dmesh, rules)
        tp = ctx.axis_size("tensor")
        net = specs_lib.abstract_model(cfg, dtype,
                                       train=shape.kind == "train", tp=tp)
        distribute(net, mod.param_defs(cfg, tp), dmesh, rules)
        inputs = abstract_inputs(cfg, mod, shape, net, dtype)
        if "cache" in inputs:
            inputs["cache"] = distribute_tree(
                inputs["cache"], mod.cache_defs(cfg, shape.global_batch,
                                                shape.seq_len), dmesh, rules)
        flops, coll, _ = costs.count_collectives(
            step_fn(cfg, mod, shape.kind, ctx), net, inputs)
    return {"flops_per_device": flops, "collectives": coll,
            "count_s": round(time.perf_counter() - t0, 2)}


def measure(arch: str, shape: ShapeConfig,
            meshes: Sequence[str] = tuple(MESHES), *,
            dtype: Optional[torch.dtype] = None,
            reduced: bool = False) -> List[dict]:
    """One record per mesh of the cell ``arch`` x ``shape`` (any
    ``ShapeConfig``: a cut of a ``SHAPES`` cell too), in ``dtype`` (default:
    the config's ``param_dtype``).  The step runs once, unpartitioned, on
    ``meta`` (``flops_per_device`` is the even split until
    :func:`add_partitioned`); errors raise."""
    cfg, mod = registry.get(arch, reduced=reduced)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    t0 = time.perf_counter()
    net = specs_lib.abstract_model(cfg, dtype, train=shape.kind == "train")
    inputs = abstract_inputs(cfg, mod, shape, net, dtype)
    flops, out = costs.count_flops(step_fn(cfg, mod, shape.kind), net,
                                   inputs)
    count_s = time.perf_counter() - t0
    recs = []
    for m in meshes:
        mem = memory(cfg, mod, shape, m, dtype)
        n_dev = MESHES[m].n_devices
        rec = {
            "arch": arch, "shape": shape.name, "mesh": m, "status": "ok",
            "kind": shape.kind, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch, "reduced": reduced,
            "dtype": str(dtype).removeprefix("torch."),
            "n_devices": n_dev, "memory": mem,
            "fits_one_h100": mem["argument_bytes"] + mem["output_bytes"]
            <= costs.HBM_BYTES,
            "flops": flops, "flops_per_device": flops / n_dev,
            "model_flops": model_flops_for(cfg, shape),
            "flops_source": "meta", "count_s": round(count_s, 2),
            "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count(),
        }
        recs.append(rec)
    return recs


def add_partitioned(recs: List[dict], shape: ShapeConfig) -> List[dict]:
    """``recs`` (:func:`measure`'s) with each production mesh's record
    holding its partitioned step's count (:func:`partitioned`):
    ``flops_per_device`` as counted on one rank, ``flops_even_split``
    beside it, ``collectives`` and the ``program_mesh``."""
    for rec in recs:
        if rec["n_devices"] == 1:
            continue
        part = partitioned(rec["arch"], shape, rec["mesh"],
                           dtype=getattr(torch, rec["dtype"]),
                           reduced=rec["reduced"])
        rec.update(flops_even_split=rec["flops"] / rec["n_devices"],
                   flops_per_device=part["flops_per_device"],
                   collectives=part["collectives"],
                   program_mesh=list(program_mesh(MESHES[rec["mesh"]]).sizes),
                   partitioned_count_s=part["count_s"])
    return recs


def _path(arch: str, shape_name: str, mesh_name: str) -> pathlib.Path:
    return REPORT_DIR / f"{arch}__{shape_name}__{mesh_name}.json"


def run_cell(arch: str, shape_name: str, meshes: Sequence[str],
             force: bool = False) -> List[dict]:
    """The records of ``arch`` x ``shape_name`` on ``meshes``, from their
    files where every mesh has one without an error (unless ``force``),
    else measured and written."""
    paths = [_path(arch, shape_name, m) for m in meshes]
    if not force and all(p.exists() for p in paths):
        cached = [json.loads(p.read_text()) for p in paths]
        if all(r.get("status") != "error" for r in cached):  # retry errors
            print(f"[skip] {arch} x {shape_name} (cached)", flush=True)
            return cached
    cfg, _ = registry.get(arch)
    if not runnable(cfg, shape_name):
        recs = [{"arch": arch, "shape": shape_name, "mesh": m,
                 "status": "skipped",
                 "reason": "full-attention arch at 524k context is "
                           "quadratic; cell runs only for SSM/hybrid "
                           "(DESIGN.md §Arch-applicability)"}
                for m in meshes]
        print(f"[skip-by-design] {arch} x {shape_name}", flush=True)
    else:
        try:
            recs = add_partitioned(measure(arch, SHAPES[shape_name], meshes),
                                   SHAPES[shape_name])
        except Exception as e:  # record failures; the grid keeps going
            recs = [{"arch": arch, "shape": shape_name, "mesh": m,
                     "status": "error", "error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()[-4000:]}
                    for m in meshes]
            print(f"[FAIL] {arch} x {shape_name}: {e}", flush=True)
    REPORT_DIR.mkdir(parents=True, exist_ok=True)
    for p, rec in zip(paths, recs):
        p.write_text(json.dumps(rec, indent=2))
    for rec in recs:
        if rec["status"] == "ok":
            mem = rec["memory"]
            print(f"[ok] {arch} x {shape_name} x {rec['mesh']} "
                  f"(count {rec['count_s']} s, flops {rec['flops']:.4e}, "
                  f"args/dev {mem['argument_bytes'] / 2**30:.2f} GiB, "
                  f"out/dev {mem['output_bytes'] / 2**30:.2f} GiB, "
                  f"fits_one_h100={rec['fits_one_h100']})", flush=True)
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="all", choices=[*MESHES, "all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    # a full-width prefill_32k cell counts for minutes (Python overhead per
    # op on meta): cells run in worker processes
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (default 1)")
    args = ap.parse_args(argv)

    if args.all:
        archs, shapes = registry.names(), list(SHAPES)
    else:
        archs = [args.arch] if args.arch else registry.names()
        shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    cells = [(a, s, meshes, args.force) for a in archs for s in shapes]
    # the prefill cells count longest (every attention chunk of 32k
    # positions): they start first
    cells.sort(key=lambda c: SHAPES[c[1]].kind != "prefill")
    t0 = time.perf_counter()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=ctx) as pool:
            futs = [pool.submit(run_cell, *c) for c in cells]
            results = [f.result() for f in futs]
    else:
        results = [run_cell(*c) for c in cells]
    failures = sum(r.get("status") == "error" for recs in results
                   for r in recs)
    print(f"done in {time.perf_counter() - t0:.1f} s; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
