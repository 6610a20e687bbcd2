"""Helpers of the port's model parity tests (``test_torch_decode.py``,
``test_torch_moe.py``, ``test_torch_ssm.py``, ``test_torch_hybrid.py``):
one JAX initialisation handed to both packages, caches and trees as numpy,
the forward / prefill / decode checks of the recurrent families, and one
train step in each package from the same parameters and batch.

The train-step tolerance is ``tests/test_torch_train.py``'s: parameters
within ``rtol = 1e-4, atol = 1e-6`` wherever the reference's gradient
stands clear of its f32 rounding (``|g| >= G_FLOOR`` or exactly 0); AdamW
divides a gradient by its RMS, so an element whose gradient is near its
rounding moves by a share of ``lr`` that the rounding decides: those
elements (at most 1 in 1,000 of a dense model, 1 in 200 of an MoE model,
whose experts see few tokens; checked) are held within ``2 lr``.  The
hybrid's gradients differ between the packages by up to 6.3e-6 (largest
gradient 2.1; smollm's by 1.2e-6), so its floor is ``1e-5``.
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
    """The reference test's growth of a prefill cache (numpy): only the
    sequence-indexed entries (``k``, ``v``, ``*ckv``, ``*kr``) are padded
    along axis 2 (``tests/test_models_smoke.py::test_decode_matches_forward``);
    an SSM's ``conv`` window and ``state`` have no sequence axis."""
    out = {}
    for k, v in cache.items():
        if v is not None and (k in ("k", "v") or k.endswith("ckv")
                              or k.endswith("kr")):
            pad = [(0, 0)] * v.ndim
            pad[2] = (0, length - v.shape[2])
            v = np.pad(v, pad)
        out[k] = v
    return out


def model_pair(arch, seed, **replace):
    """``(cfg, port module, port model, reference module, reference
    params)`` at ``reduced()`` with ``replace``, the port's model built on
    the CPU from the reference's f32 init."""
    cfg, mod, rmod, rcfg = configs(arch, **replace)
    params = reference_params(rmod, rcfg, seed)
    return cfg, mod, mod.build(cfg, as_numpy(params), device="cpu"), rmod, \
        params


def tokens(cfg, seed, B=2, S=16):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def check_forward(pair, S, atol):
    """Logits and ``return_hidden`` against the reference's."""
    cfg, mod, model, rmod, params = pair
    t = tokens(cfg, S, S=S)
    for hidden in (False, True):
        got = mod.forward(model, {"tokens": torch.as_tensor(t)}, cfg,
                          return_hidden=hidden)
        want = rmod.forward(params, {"tokens": jnp.asarray(t)}, cfg,
                            return_hidden=hidden)
        width = cfg.d_model if hidden else cfg.vocab_padded()
        assert tuple(got.shape) == (2, S, width)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)


def check_prefill(pair, S, atol):
    """The prefill cache against the reference's, key by key; returns the
    port's cache."""
    cfg, mod, model, rmod, params = pair
    t = tokens(cfg, 2, S=S)
    lg, cache = mod.forward(model, {"tokens": torch.as_tensor(t)}, cfg,
                            return_cache=True)
    rlg, rcache = rmod.forward(params, {"tokens": jnp.asarray(t)}, cfg,
                               return_cache=True)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=0,
                               atol=atol)
    assert set(cache) == set(rcache)
    for k in cache:
        want = np.asarray(rcache[k])
        assert tuple(cache[k].shape) == want.shape, k
        np.testing.assert_allclose(cache[k].numpy(), want, rtol=0,
                                   atol=atol, err_msg=k)
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == S - 1
    return cache


def check_decode_steps(pair, S, atol, steps=3):
    """``steps`` decode steps from the reference's grown prefill cache:
    logits and every cache entry after each step against the reference's
    ``decode_step``."""
    cfg, mod, model, rmod, params = pair
    t = tokens(cfg, 3, S=S + steps)
    _, rcache = rmod.forward(params, {"tokens": jnp.asarray(t[:, :S])}, cfg,
                             return_cache=True)
    rcache = grow(cache_numpy(rcache), S + 8)
    cache = {k: torch.tensor(v) for k, v in rcache.items()}
    rcache = {k: jnp.asarray(v) for k, v in rcache.items()}
    for i in range(steps):
        step = t[:, S + i:S + i + 1]
        lg, cache = mod.decode_step(model, cache, torch.as_tensor(step), cfg)
        rlg, rcache = rmod.decode_step(params, rcache, jnp.asarray(step),
                                       cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=0,
                                   atol=atol)
        assert set(cache) == set(rcache)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]),
                                       rtol=0, atol=atol, err_msg=k)
        assert int(cache["pos"]) == S + i


def check_decode_matches_forward(pair, S):
    """The reference's check on the port: ``decode_step`` after a prefill of
    S-1 tokens gives ``forward``'s logits at S-1 (its ``rtol = 2e-2, atol =
    2e-3``)."""
    from repro_torch.models.common import grow_cache
    cfg, mod, model, _, _ = pair
    t = torch.as_tensor(tokens(cfg, 4, S=S))
    logits = mod.forward(model, {"tokens": t}, cfg)
    _, cache = mod.forward(model, {"tokens": t[:, :S - 1]}, cfg,
                           return_cache=True)
    lg, cache2 = mod.decode_step(model, grow_cache(cache, S + 8),
                                 t[:, S - 1:S], cfg)
    np.testing.assert_allclose(lg[:, 0].numpy(), logits[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-3)
    assert int(cache2["pos"]) == S - 1


def check_params_round_trip(arch, seed, **replace):
    """``params_from_jax`` -> the model's ``state_dict`` -> ``params_to_jax``
    gives the reference's tree back bit for bit; ``decay_mask`` is the
    reference optimizer's rule (``ndim >= 2`` of its tree's leaves) in the
    reference's leaf order.  Returns the port's state and mask."""
    from repro_torch.models.params import params_from_jax, port_leaves
    cfg, mod, model, rmod, params = model_pair(arch, seed, **replace)
    tree = as_numpy(params)
    state = params_from_jax(tree)
    assert set(state) == set(model.state_dict())
    back = params_to_jax(model.state_dict(), mod.param_defs(cfg))
    flat_ref, flat_back = flat(tree), flat(back)
    assert list(flat_ref) == list(flat_back)
    for k, a in flat_ref.items():
        np.testing.assert_array_equal(flat_back[k], a, err_msg=k)
    mask = decay_mask(mod.param_defs(cfg))
    want = {}
    for path, _, names in port_leaves(mod.param_defs(cfg)):
        for n in names:
            want[n] = flat_ref["/".join(path)].ndim >= 2
    assert list(mask.items()) == list(want.items())
    return state, mask


def train_step_pair(arch, seed, b, g_floor=G_FLOOR, **replace):
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
    near = {k: (np.abs(g) > 0) & (np.abs(g) < g_floor)
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
