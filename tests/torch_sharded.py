"""Helpers of the port's partitioned-program tests
(``tests/test_torch_sharded_*.py``): the JAX reference's sharded outputs,
made in subprocesses on a 4-device CPU mesh (``tests/torch_sharded_ref.py``,
one per mesh, run side by side), and the port's, made by a real ``gloo``
group of :data:`WORLD` CPU processes under ``Ctx`` from the same
parameters (handed over with ``params_from_jax``).

Every group gets a ``FileStore`` in the test's temporary directory (no TCP
port) and a :data:`TIMEOUT` on its collectives, and is destroyed in a
``finally``; the parent waits at most :data:`WAIT` for the ranks (and for
the reference's subprocesses) and kills them after it, so a rank that
never reaches a collective fails its test instead of hanging the suite.  Ranks return numpy arrays (rank 0's,
gathered with ``full_tensor``) through a pickle in that directory.

Tolerances are the unsharded f32 checks' (``tests/torch_parity.py``'s
helpers): logits, hidden states and caches within ``atol = 1e-4``; one
train step as ``torch_parity.assert_params_close`` states.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np

WORLD = 4
#: seconds a collective may wait (the group's timeout) and the parent waits
#: for its ranks and subprocesses (more: a host running other tests slows
#: them down)
TIMEOUT = 60.0
WAIT = 300.0
MESHES = [(2, 2), (1, 4), (4, 1)]
ATOL = 1e-4
#: batch, prompt, decode steps and the room a prefill cache grows by
B, S, STEPS, GROW = 4, 16, 3, 8
#: the jobs of a mesh: serving's forward, prefill and decode steps under
#: SERVE_RULES, a forward and a train step under TRAIN_RULES
SERVE = {"rules": "SERVE_RULES", "what": ["forward", "decode"]}
TRAIN = {"rules": "TRAIN_RULES", "what": ["forward", "train"]}
HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def jobs_for(mesh, jobs):
    return [{"mesh": list(mesh), **j} for j in jobs]


def start_reference(arch: str, replace: dict, params: pathlib.Path,
                    tmp: pathlib.Path, meshes, jobs) -> list:
    """Start the reference's sharded runs of ``arch`` on ``meshes``, one
    subprocess per mesh; :func:`reference` collects them."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false",
           "PYTHONPATH": os.pathsep.join([str(SRC), str(HERE)])}
    procs = []
    for m in meshes:
        tag = f"{m[0]}x{m[1]}"
        spec = tmp / f"jobs_{tag}.json"
        spec.write_text(json.dumps({"replace": replace,
                                    "jobs": jobs_for(m, jobs)}))
        out = tmp / f"ref_{tag}.npz"
        procs.append((out, subprocess.Popen(
            [sys.executable, str(HERE / "torch_sharded_ref.py"), arch,
             str(spec), str(params), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    return procs


def reference(procs: list) -> dict:
    """The outputs of :func:`start_reference`'s runs, once they end (each
    within :data:`WAIT`)."""
    res = {}
    try:
        for out, p in procs:
            log, _ = p.communicate(timeout=WAIT)
            assert p.returncode == 0, log.decode()[-4000:]
            with np.load(out) as z:
                res.update({k: z[k] for k in z.files})
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
    return res


def sub(tree: dict, prefix: str) -> dict:
    """The entries of a flat ``{"a/b/c": array}`` dict under ``prefix``,
    keyed by the rest of their path."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tree.items() if k.startswith(prefix + "/")}


def unflat(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn, args, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)   # tiny ops: threads would only contend
    store = dist.FileStore(os.path.join(tmp, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        out = fn(rank, *args)
        if rank == 0:
            with open(os.path.join(tmp, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, args, tmp: pathlib.Path):
    """``fn(rank, *args)`` on each of :data:`WORLD` spawned ranks of one
    ``gloo`` group; returns rank 0's result.  Fails (killing the ranks)
    after :data:`WAIT` seconds or if any rank raises."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(fn, args, str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + WAIT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after {WAIT} s")
    except ProcessException as e:
        errs = sorted(tmp.glob("err*.txt"))
        raise AssertionError(errs[0].read_text() if errs else str(e))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def _full(x):
    """A ``DTensor`` (or tensor) as a numpy array of its global value."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def _cache_np(cache: dict) -> dict:
    return {k: None if v is None else _full(v) for k, v in cache.items()}


def port_jobs(rank: int, arch: str, replace: dict, meshes, jobs,
              params: dict) -> dict:
    """The port's outputs of ``jobs`` on ``meshes`` (rank 0 returns
    them, the others None): the keys ``tests/torch_sharded_ref.py`` writes,
    from the reference's ``params`` per ``tp``.  The decode steps start
    from the port's own prefill cache, grown as the reference's is."""
    import torch

    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import registry
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import (decay_mask, distribute,
                                           distribute_tree, params_to_jax)
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_state as ts
    from torch_parity import OCFG, batch, configs, flat, grow, tokens

    cfg, mod, _, _ = configs(arch, **replace)
    out = {}
    for m in meshes:
        mesh = device_mesh(Mesh(("data", "model"), tuple(m)), "cpu")
        for job in jobs_for(m, jobs):
            rules = getattr(shd, job["rules"])
            ctx = Ctx(mesh, rules)
            tp = ctx.axis_size("tensor")
            tree = unflat(sub(params, f"params/tp{tp}"))
            defs = mod.param_defs(cfg, tp)
            key = f"{m[0]}x{m[1]}/{job['rules']}"

            def net():
                model = mod.build(cfg, tree, dtype=torch.float32,
                                  device="cpu", tp=tp)
                distribute(model, defs, mesh, rules)
                return model
            if "forward" in job["what"]:
                res = mod.forward(net(), {"tokens": torch.as_tensor(
                    tokens(cfg, S, B=B, S=S))}, cfg, ctx)
                res = res if isinstance(res, tuple) else (res,)
                out[f"{key}/forward/logits"] = _full(res[0])
                if len(res) > 1:
                    out[f"{key}/forward/aux"] = _full(res[1])
            if "decode" in job["what"]:
                model = net()
                t = tokens(cfg, 3, B=B, S=S + STEPS)
                res = mod.forward(model, {"tokens": torch.as_tensor(
                    t[:, :S])}, cfg, ctx, return_cache=True)
                out[f"{key}/prefill/logits"] = _full(res[0])
                prefilled = _cache_np(res[-1])
                for k, v in prefilled.items():
                    out[f"{key}/prefill/cache/{k}"] = v
                cdefs = mod.cache_defs(cfg, B, S + GROW)
                cache = distribute_tree(
                    {k: None if v is None else torch.tensor(v)
                     for k, v in grow(prefilled, S + GROW).items()},
                    cdefs, mesh, rules)
                for i in range(STEPS):
                    lg, cache = mod.decode_step(model, cache, torch.as_tensor(
                        t[:, S + i:S + i + 1]), cfg, ctx)
                    out[f"{key}/decode/logits{i}"] = _full(lg)
                    for k, v in _cache_np(cache).items():
                        out[f"{key}/decode/cache{i + 1}/{k}"] = v
            if "train" in job["what"]:
                model = net().requires_grad_(True)
                ocfg = opt.OptConfig(**OCFG)
                named = dict(model.named_parameters())
                state = opt.init_state({k: named[k] for k in
                                        decay_mask(defs)}, ocfg)
                b = batch(cfg, np.random.default_rng(7), B=B, S=S)
                model, state, met = ts.make_train_step(
                    mod, cfg, ocfg, ctx)(model, state, b)
                full = {k: torch.as_tensor(_full(v))
                        for k, v in model.state_dict().items()}
                for k, v in flat(params_to_jax(full, defs)).items():
                    out[f"{key}/train/params/{k}"] = v
                for k, v in met.items():
                    out[f"{key}/train/metrics/{k}"] = _full(
                        torch.as_tensor(v) if not torch.is_tensor(v) else v)
    if rank:
        return None
    return out


def outputs(arch: str, tmp: pathlib.Path, jobs, meshes=MESHES,
            **replace) -> "Pair":
    """Both packages' sharded outputs of ``jobs`` for ``arch`` (at
    ``reduced()`` with ``replace``) on ``meshes``, from one reference init
    per ``tp``: the reference's runs and the port's ranks run side by
    side."""
    from torch_sharded_ref import init_params_np
    tmp.mkdir(parents=True, exist_ok=True)
    params = init_params_np(arch, replace, [m[1] for m in meshes])
    np.savez(tmp / "params.npz", **params)
    procs = start_reference(arch, replace, tmp / "params.npz", tmp, meshes,
                            jobs)
    try:
        got = run_ranks(port_jobs, (arch, replace, meshes, jobs, params),
                        tmp / "ranks")
    finally:
        want = reference(procs)
    return Pair(want, got)


@dataclasses.dataclass
class Pair:
    """The reference's and the port's outputs, flat, keyed alike."""

    want: dict
    got: dict

    def check(self, prefix: str, atol: float = ATOL) -> int:
        """Every output under ``prefix`` within ``atol`` (the unsharded
        checks' ``rtol = 0``); returns how many were held."""
        keys = [k for k in self.want if k.startswith(prefix + "/")]
        assert keys, prefix
        for k in keys:
            assert k in self.got, k
            assert self.got[k].shape == self.want[k].shape, k
            np.testing.assert_allclose(self.got[k], self.want[k], rtol=0,
                                       atol=atol, err_msg=k)
        return len(keys)

    def check_train(self, key: str, max_loose: float = 1e-3) -> None:
        """One train step: parameters as ``torch_parity.assert_params_close``
        holds them (``near`` from the reference's gradients), the loss,
        aux loss and gradient norm within ``rtol = atol = 1e-5`` and the
        learning rate exact."""
        from torch_parity import G_FLOOR, assert_params_close
        want = sub(self.want, f"{key}/train/params")
        got = sub(self.got, f"{key}/train/params")
        near = {k: (np.abs(g) > 0) & (np.abs(g) < G_FLOOR) for k, g in
                sub(self.want, f"{key}/train/grads").items()}
        assert_params_close(got, want, near, max_loose=max_loose)
        wm = sub(self.want, f"{key}/train/metrics")
        gm = sub(self.got, f"{key}/train/metrics")
        for k in ("loss", "aux_loss", "grad_norm", "total_loss"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_array_equal(gm["lr"], wm["lr"])


# ---------------------------------------------------------------------------
# units: the sharded cache write and the expert-parallel dispatch
# ---------------------------------------------------------------------------

def units(rank: int, cache_cases, moe_cases) -> dict:
    """:func:`cache_write` of each ``(mesh, pos)`` and :func:`moe_kept` of
    each ``(mesh, rules, params, x)``, in one group."""
    return {"cache": {c: cache_write(rank, *c) for c in cache_cases},
            "moe": {c[0]: moe_kept(rank, *c) for c in moe_cases}}


def cache_write(rank: int, mesh_shape, pos: int) -> dict:
    """``update_cache`` of ones at ``pos`` into a zero ``(1, 4, 8, 2, 4)``
    cache laid out by ``cache_defs``' axes under SERVE_RULES (length split
    over ``model``): per rank whether its shard changed and where, and the
    whole cache after."""
    import torch

    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models.layers import Ctx, update_cache
    import torch.distributed as dist
    mesh = device_mesh(Mesh(("data", "model"), tuple(mesh_shape)), "cpu")
    ctx = Ctx(mesh, shd.SERVE_RULES)
    axes = ("layers", "batch", "kv_seq", None, None)
    cache = ctx.constrain(torch.zeros(1, 4, 8, 2, 4), *axes)
    new = torch.arange(1 * 4 * 2 * 4, dtype=torch.float32).reshape(
        1, 4, 1, 2, 4) + 1
    out = update_cache(cache, new, torch.tensor(pos, dtype=torch.int32), ctx,
                       seq_axis=2)
    loc = out.to_local()
    changed = sorted({int(i) for i in loc.nonzero()[:, 2]})
    mine = [None] * WORLD
    dist.all_gather_object(mine, (rank, out is cache, tuple(loc.shape),
                                  changed))
    full = out.full_tensor().numpy()
    return {"ranks": mine, "full": full,
            "placements": [str(p) for p in out.placements]}


def moe_kept(rank: int, mesh_shape, rules: str, params: dict, x) -> dict:
    """One MoE layer (deepseek-v2-236b at ``reduced()``, layer 1, from the
    reference's ``params``) on ``x`` under ``Ctx``: its output and aux (whole)
    and, per data shard, the ``(token, expert)`` assignments its dispatch
    kept, tokens numbered within the shard and experts globally."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import layers, registry
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import distribute
    cfg, mod = registry.get("deepseek-v2-236b", reduced=True)
    mesh = device_mesh(Mesh(("data", "model"), tuple(mesh_shape)), "cpu")
    ctx = Ctx(mesh, getattr(shd, rules))
    tp = ctx.axis_size("tensor")
    model = mod.build(cfg, unflat(params), dtype=torch.float32,
                      device="cpu", tp=tp)
    distribute(model, mod.param_defs(cfg, tp), mesh, ctx.rules)
    seen = []
    dispatch = layers.moe_dispatch

    def spy(gates, idx, n_experts, capacity, expert_offset=0):
        buf_t, buf_g = dispatch(gates, idx, n_experts, capacity,
                                expert_offset)
        seen.append({(int(t) - 1, int(expert_offset) + e)
                     for e in range(n_experts) for t in buf_t[e] if t > 0})
        return buf_t, buf_g
    layers.moe_dispatch = spy
    try:
        with ctx.scope(), torch.no_grad():
            out, aux = layers.moe_block(model.moe_layers[0], ctx.constrain(
                torch.as_tensor(x), "batch", None, None), cfg, ctx)
    finally:
        layers.moe_dispatch = dispatch
    names = list(mesh.mesh_dim_names)
    shard = mesh.get_local_rank(names.index("data"))
    kept = [None] * WORLD
    dist.all_gather_object(kept, (shard, seen[0] if seen else set()))
    per_shard: dict = {}
    for d, k in kept:
        per_shard.setdefault(d, set()).update(k)
    return {"out": _full(out), "aux": _full(aux), "kept": per_shard}
