"""Helpers of the port's model parity tests (``test_torch_decode.py``,
``test_torch_moe.py``): one JAX initialisation handed to both packages,
caches and trees as numpy, and one train step in each package from the
same parameters and batch.

The train-step tolerance is ``tests/test_torch_train.py``'s: parameters
within ``rtol = 1e-4, atol = 1e-6`` wherever the reference's gradient
stands clear of its f32 rounding (``|g| >= G_FLOOR`` or exactly 0); AdamW
divides a gradient by its RMS, so an element whose gradient is near its
rounding moves by a share of ``lr`` that the rounding decides: those
elements (at most 1 in 1,000 of a dense model, 1 in 200 of an MoE model,
whose experts see few tokens; checked) are held within ``2 lr``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import registry as ref_registry
from repro.models.params import init_params as ref_init
from repro.train import optimizer as ref_opt
from repro.train import train_state as ref_ts
from repro_torch.models import registry
from repro_torch.models.params import decay_mask, params_to_jax
from repro_torch.train import optimizer as opt
from repro_torch.train import train_state as ts

OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
G_FLOOR = 1e-6


def flat(tree, prefix=()):
    """A nested dict as ``{"a/b": leaf}`` (None leaves dropped)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        elif v is not None:
            out["/".join(prefix + (k,))] = v
    return out


def as_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def configs(arch, **replace):
    """``(cfg, port module, reference module)`` at ``reduced()``, with the
    same replacements applied in both packages."""
    cfg, mod = registry.get(arch, reduced=True)
    rcfg, rmod = ref_registry.get(arch, reduced=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    return dataclasses.replace(cfg, **replace), mod, rmod, \
        dataclasses.replace(rcfg, **replace)


def reference_params(rmod, rcfg, seed):
    """The reference's f32 init; zero-initialised QKV biases are redrawn so
    their branch does something."""
    params = ref_init(rmod.param_defs(rcfg), jax.random.PRNGKey(seed),
                      jnp.float32)
    if "layers" in params and "bq" in params["layers"]:
        rng = np.random.default_rng(seed + 100)
        for b in ("bq", "bk", "bv"):
            params["layers"][b] = jnp.asarray(rng.normal(
                scale=0.5, size=params["layers"][b].shape), jnp.float32)
    return params


def batch(cfg, rng, B=2, S=16):
    """``tests/test_models_smoke.py:_batch``: tokens and labels, and for the
    modality configs a prefix of ``embeds`` whose labels are -1."""
    prefix = min(cfg.frontend_prefix, 4) if cfg.frontend != "none" else 0
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S - prefix)).astype(
             np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if prefix:
        b["embeds"] = rng.normal(size=(B, prefix, cfg.d_model)).astype(
            np.float32)
        b["labels"][:, :prefix] = -1
    return b


def cache_numpy(cache):
    return {k: (None if v is None else np.asarray(v)) for k, v in
            cache.items()}


def grow(cache, length):
    """The reference test's growth of a prefill cache (numpy)."""
    out = {}
    for k, v in cache.items():
        if v is not None and v.ndim >= 3:
            pad = [(0, 0)] * v.ndim
            pad[2] = (0, length - v.shape[2])
            v = np.pad(v, pad)
        out[k] = v
    return out


def train_step_pair(arch, seed, b, **replace):
    """One train step of each package from the reference's init at
    ``reduced()``: ``(port metrics, reference metrics, port params,
    reference params, near)`` with the parameters flattened as numpy and
    ``near`` the elements whose reference gradient came near its
    rounding."""
    cfg, mod, rmod, rcfg = configs(arch, **replace)
    params = reference_params(rmod, rcfg, seed)
    ocfg = opt.OptConfig(**OCFG)
    model = mod.build(cfg, as_numpy(params), dtype=torch.float32,
                      device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    state = opt.init_state({k: named[k] for k in decay_mask(
        mod.param_defs(cfg))}, ocfg)
    model, state, got_m = ts.make_train_step(mod, cfg, ocfg)(model, state, b)
    got = flat(params_to_jax(model.state_dict(), mod.param_defs(cfg)))

    rocfg = ref_opt.OptConfig(**OCFG)
    jb = jax.tree.map(jnp.asarray, b)
    grads = jax.jit(jax.grad(lambda p: ref_ts.make_loss_fn(rmod, rcfg)(
        p, jb)[0]))(params)
    near = {k: (np.abs(g) > 0) & (np.abs(g) < G_FLOOR)
            for k, g in flat(as_numpy(grads)).items()}
    p2, _, want_m = jax.jit(ref_ts.make_train_step(rmod, rcfg, rocfg))(
        params, ref_opt.init_state(params, rocfg), jb)
    return got_m, want_m, got, flat(as_numpy(p2)), near


def assert_params_close(got, want, near, steps=1, max_loose=1e-3):
    """``max_loose``: the largest share of elements whose gradient may come
    near its rounding (MoE expert stacks, whose experts see few tokens,
    hold more of them than dense weights)."""
    assert set(got) == set(want) == set(near)
    loose = 0
    lr = OCFG["lr"]
    for k in want:
        tight = ~near[k]
        loose += int((~tight).sum())
        np.testing.assert_allclose(got[k][tight], want[k][tight],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        assert np.all(np.abs(got[k] - want[k]) <= 2 * lr * steps), k
    assert loose <= max_loose * sum(a.size for a in want.values())
