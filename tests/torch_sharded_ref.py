"""The JAX reference's partitioned program on a 4-device CPU mesh, run as a
script in a subprocess (``tests/torch_sharded.py`` starts it with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu`` set before JAX starts):

    python tests/torch_sharded_ref.py ARCH JOBS.json PARAMS.npz OUT.npz

``JOBS.json`` holds ``replace`` (config fields replaced at ``reduced()``,
a cut in depth) and ``jobs``; ``PARAMS.npz`` the reference's init per
``tp`` (``params/tp{tp}/...``, :func:`init_params`).  Each job names a mesh (``[data, model]``), a rule set (``TRAIN_RULES`` or
``SERVE_RULES``) and what to run under ``Ctx(jax.make_mesh(mesh, ("data",
"model")), rules)`` at ``reduced()`` in f32: ``forward`` (logits, and the
aux loss of an MoE model), ``decode`` (a prefill's logits and cache, then
three steps from the grown cache: logits and cache after each) and
``train`` (one step: new parameters, metrics and the gradients).  The parameters are the reference's init with heads padded to
the mesh's model axis, which the port builds from too; the inputs are
``tests/torch_parity.py``'s seeded ones at batch :data:`B`.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch import sharding as shd
from repro.models.layers import Ctx
from repro.models.params import init_params
from repro.train import optimizer as ref_opt
from repro.train import train_state as ref_ts
from torch_parity import OCFG, as_numpy, batch, cache_numpy, configs, \
    flat, grow, tokens
from torch_sharded import B, GROW, S, STEPS


def init_params_np(arch: str, replace: dict, tps) -> dict:
    """The reference's f32 init (``PRNGKey(0)``) with heads padded to each
    ``tp``, flat numpy under ``params/tp{tp}``."""
    _, _, rmod, rcfg = configs(arch, **replace)
    out: dict = {}
    for tp in sorted(set(tps)):
        _put(out, f"params/tp{tp}", as_numpy(init_params(
            rmod.param_defs(rcfg, tp), jax.random.PRNGKey(0), jnp.float32)))
    return out


def _unflat(flat_: dict) -> dict:
    out: dict = {}
    for k, v in flat_.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


def _put(out: dict, prefix: str, tree) -> None:
    if isinstance(tree, dict):
        for k, v in flat(tree).items():
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32) \
                if np.asarray(v).dtype.kind == "V" else np.asarray(v)
    elif tree is not None:
        out[prefix] = np.asarray(tree)


def run(arch: str, replace: dict, jobs: list, given: dict) -> dict:
    cfg, _, rmod, rcfg = configs(arch, **replace)
    out: dict = {}
    for job in jobs:
        shape = tuple(job["mesh"])
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        rules = dict(getattr(shd, job["rules"]))
        ctx = Ctx(mesh, rules)
        tp = ctx.axis_size("tensor")
        n = len(f"params/tp{tp}/")
        params = _unflat({k[n:]: v for k, v in given.items()
                          if k.startswith(f"params/tp{tp}/")})
        key = f"{shape[0]}x{shape[1]}/{job['rules']}"
        todo = job["what"]
        fwd = jax.jit(lambda p, b: rmod.forward(p, b, rcfg, ctx))
        prefill = jax.jit(lambda p, b: rmod.forward(p, b, rcfg, ctx,
                                                    return_cache=True))
        if "forward" in todo:
            res = fwd(params, {"tokens": jnp.asarray(tokens(cfg, S, B=B,
                                                            S=S))})
            res = res if isinstance(res, tuple) else (res,)
            _put(out, f"{key}/forward/logits", res[0])
            if len(res) > 1:
                _put(out, f"{key}/forward/aux", res[1])
        if "decode" in todo:
            t = tokens(cfg, 3, B=B, S=S + STEPS)
            res = prefill(params, {"tokens": jnp.asarray(t[:, :S])})
            _put(out, f"{key}/prefill/logits", res[0])
            _put(out, f"{key}/prefill/cache", cache_numpy(res[-1]))
            cache = grow(cache_numpy(res[-1]), S + GROW)
            cache = {k: (None if v is None else jnp.asarray(v))
                     for k, v in cache.items()}
            step = jax.jit(lambda p, c, x: rmod.decode_step(p, c, x, rcfg,
                                                            ctx))
            for i in range(STEPS):
                lg, cache = step(params, cache,
                                 jnp.asarray(t[:, S + i:S + i + 1]))
                _put(out, f"{key}/decode/logits{i}", lg)
                _put(out, f"{key}/decode/cache{i + 1}", cache_numpy(cache))
        if "train" in todo:
            b = jax.tree.map(jnp.asarray,
                             batch(cfg, np.random.default_rng(7), B=B, S=S))
            rocfg = ref_opt.OptConfig(**OCFG)
            loss_fn = ref_ts.make_loss_fn(rmod, rcfg, ctx)
            train_step = ref_ts.make_train_step(rmod, rcfg, rocfg, ctx)

            def train(p, o):
                g = jax.grad(lambda q: loss_fn(q, b)[0])(p)
                return train_step(p, o, b), g
            (p2, _, m), grads = jax.jit(train)(
                params, ref_opt.init_state(params, rocfg))
            _put(out, f"{key}/train/params", as_numpy(p2))
            _put(out, f"{key}/train/grads", as_numpy(grads))
            for k, v in m.items():
                _put(out, f"{key}/train/metrics/{k}", v)
    return out


if __name__ == "__main__":
    arch, jobs_path, params_path, out_path = sys.argv[1:5]
    with open(jobs_path) as f:
        spec = json.load(f)
    with np.load(params_path) as z:
        params = {k: z[k] for k in z.files}
    np.savez(out_path, **run(arch, spec["replace"], spec["jobs"], params))
