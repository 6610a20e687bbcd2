"""The port's MoE layer and MLA model (deepseek-v2-236b, kimi-k2-1t-a32b)
against the JAX reference on the CPU.

Inputs are seeded numpy; both models start from one JAX initialisation at
``reduced()`` in f32, handed over with ``params_from_jax``.  Tolerances (f32,
the same operations in another order or library): router gates, aux loss
and expert outputs within ``rtol = atol = 1e-5``, routed ids and the set of
dropped ``(token, expert)`` assignments exact; model logits, aux loss and
latent caches within ``atol = 1e-4``; one train step as
``tests/torch_parity.py`` states (``tests/test_torch_train.py``'s).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.params import decay_mask, port_leaves  # noqa: E402
from torch_parity import (as_numpy, assert_params_close, batch,  # noqa: E402
                          cache_numpy, configs, grow, reference_params,
                          train_step_pair)

MOE = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]
TOL = dict(rtol=1e-5, atol=1e-5)
ATOL = 1e-4
B, S = 2, 16


def _router_inputs(T, d, E, seed, skew=0.0):
    """Tokens and a router ``(d, E)``; ``skew`` adds a bias toward the first
    experts (every token leans the same way, so they overflow)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    wr = rng.normal(scale=d ** -0.5, size=(d, E)).astype(np.float32)
    if skew:
        lean = np.linspace(skew, 0.0, E).astype(np.float32)
        wr = wr + np.outer(x.mean(0) / (x.mean(0) ** 2).sum(), lean).astype(
            np.float32)
    return x, wr


@pytest.mark.parametrize("k", [1, 2, 6])
def test_moe_router_matches_reference(k):
    x, wr = _router_inputs(40, 16, 8, seed=k)
    gates, idx, aux = layers.moe_router(torch.as_tensor(x),
                                        torch.as_tensor(wr.T.copy()), k)
    rg, ridx, raux = ref_layers.moe_router(jnp.asarray(x), jnp.asarray(wr), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rg), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, **TOL)


def _kept(buf_t, E, T, k, idx):
    """The ``(token, expert)`` assignments a dispatch kept, from its token
    buffer, and all of them."""
    kept = {(int(t) - 1, e) for e in range(E) for t in buf_t[e] if t > 0}
    every = {(t, int(e)) for t in range(T) for e in idx[t]}
    return kept, every


def _oracle_kept(idx, E, capacity):
    """Token-major first-come ranks in plain Python: assignment ``(t, j)``
    is kept while its expert has fewer than ``capacity`` earlier ones."""
    seen, kept = [0] * E, set()
    for t, row in enumerate(np.asarray(idx)):
        for e in row:
            if seen[e] < capacity:
                kept.add((t, int(e)))
            seen[e] += 1
    return kept


@pytest.mark.parametrize("capacity", [3, 8])
def test_moe_expert_compute_drops_the_reference_tokens(capacity):
    """A skewed router overflows the first experts: the same output as the
    reference's, and the same dropped assignments as token-major ranks."""
    T, d, E, k, f = 24, 16, 6, 2, 8
    x, wr = _router_inputs(T, d, E, seed=capacity, skew=4.0)
    rng = np.random.default_rng(capacity + 1)
    wg, wu = (rng.normal(scale=d ** -0.5, size=(E, d, f)).astype(np.float32)
              for _ in range(2))
    wd = rng.normal(scale=f ** -0.5, size=(E, f, d)).astype(np.float32)
    rg, ridx, _ = ref_layers.moe_router(jnp.asarray(x), jnp.asarray(wr), k)
    want = ref_layers.moe_expert_compute(
        jnp.asarray(x), rg, ridx, jnp.asarray(wg), jnp.asarray(wu),
        jnp.asarray(wd), n_experts=E, expert_offset=0, capacity=capacity)
    gates, idx = torch.tensor(np.asarray(rg)), torch.tensor(
        np.asarray(ridx)).long()
    got = layers.moe_expert_compute(
        torch.as_tensor(x), gates, idx, *map(torch.as_tensor, (wg, wu, wd)),
        capacity=capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    buf_t, buf_g = layers.moe_dispatch(gates, idx, E, capacity)
    kept, every = _kept(buf_t.numpy(), E, T, k, idx.numpy())
    assert kept == _oracle_kept(idx, E, capacity)
    assert len(every - kept) > 0  # the skew drops assignments
    if capacity == 3:
        assert len(every - kept) >= T * k - E * capacity


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(arch):
    cfg, mod, rmod, rcfg = configs(arch)
    params = reference_params(rmod, rcfg, seed=3)
    model = mod.build(cfg, as_numpy(params), device="cpu")
    p = model.moe_layers[0]
    rp = {k: v[0] if not isinstance(v, dict) else {
        kk: vv[0] for kk, vv in v.items()}
        for k, v in params["moe_layers"].items()}
    x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    got, aux = layers.moe_block(p, torch.as_tensor(x), cfg)
    want, raux = jax.jit(ref_layers.moe_block, static_argnums=2)(
        rp, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    arch = request.param
    cfg, mod, rmod, rcfg = configs(arch)
    params = reference_params(rmod, rcfg, seed=MOE.index(arch) + 10)
    model = mod.build(cfg, as_numpy(params), device="cpu")
    return cfg, mod, model, rmod, params


def _tokens(cfg, seed, n=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, n)).astype(np.int32)


def test_forward_logits_and_aux_match_reference(pair):
    cfg, mod, model, rmod, params = pair
    tokens = _tokens(cfg, 1)
    lg, aux = mod.forward(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    rlg, raux = rmod.forward(params, {"tokens": jnp.asarray(tokens)}, cfg)
    assert lg.shape == (B, S, cfg.vocab_padded())
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    hidden = mod.forward(model, {"tokens": torch.as_tensor(tokens)}, cfg,
                         return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(rmod.forward(
        params, {"tokens": jnp.asarray(tokens)}, cfg, return_hidden=True)),
        rtol=0, atol=ATOL)


def test_prefill_latent_caches_match_reference(pair):
    cfg, mod, model, rmod, params = pair
    tokens = _tokens(cfg, 2, S - 1)
    lg, aux, cache = mod.forward(model, {"tokens": torch.as_tensor(tokens)},
                                 cfg, return_cache=True)
    rlg, raux, rcache = rmod.forward(
        params, {"tokens": jnp.asarray(tokens)}, cfg, return_cache=True)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=0,
                               atol=ATOL)
    assert set(cache) == set(rcache)
    nd = cfg.first_dense_layers
    shapes = {"dense_ckv": (nd, B, S - 1, cfg.kv_lora),
              "dense_kr": (nd, B, S - 1, cfg.rope_head_dim),
              "moe_ckv": (cfg.n_layers - nd, B, S - 1, cfg.kv_lora),
              "moe_kr": (cfg.n_layers - nd, B, S - 1, cfg.rope_head_dim)}
    for k, shape in shapes.items():
        assert tuple(cache[k].shape) == shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]),
                                   rtol=0, atol=ATOL)
    assert int(cache["pos"]) == int(rcache["pos"]) == S - 2
    want = {k: v.shape for k, v in mod.cache_defs(cfg, B, S - 1).items()
            if v is not None and k != "pos"}
    assert want == {k: tuple(cache[k].shape) for k in want}


def test_absorbed_decode_step_matches_reference(pair):
    """Two absorbed-MLA decode steps on the same grown latent cache (at the
    default capacity factor: a decode step routes B tokens, under the
    8-slot floor): logits and the updated caches after each."""
    cfg, mod, model, rmod, params = pair
    tokens = _tokens(cfg, 3, S + 1)
    _, _, rcache = rmod.forward(params, {"tokens": jnp.asarray(
        tokens[:, :S - 1])}, cfg, return_cache=True)
    rcache = grow(cache_numpy(rcache), S + 8)
    cache = {k: torch.tensor(v) for k, v in rcache.items()}
    rcache = {k: jnp.asarray(v) for k, v in rcache.items()}
    for t in (S - 1, S):
        step = tokens[:, t:t + 1]
        lg, cache = mod.decode_step(model, cache, torch.as_tensor(step), cfg)
        rlg, rcache = rmod.decode_step(params, rcache, jnp.asarray(step),
                                       cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=0,
                                   atol=ATOL)
        for k in ("dense_ckv", "dense_kr", "moe_ckv", "moe_kr"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(rcache[k]), rtol=0,
                                       atol=ATOL)
        assert int(cache["pos"]) == int(rcache["pos"]) == t


def test_decode_matches_forward(pair):
    """The reference's check with ``capacity_factor=100`` (no drops in the
    batched forward): decode after a prefill of S-1 tokens gives the
    forward's logits at S-1, within its ``rtol = 2e-2, atol = 2e-3``."""
    from repro_torch.models.common import grow_cache
    cfg, mod, model, _, _ = pair
    cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    model.cfg = cfg
    try:
        tokens = torch.as_tensor(_tokens(cfg, 4))
        logits, _ = mod.forward(model, {"tokens": tokens}, cfg)
        _, _, cache = mod.forward(model, {"tokens": tokens[:, :S - 1]}, cfg,
                                  return_cache=True)
        lg, cache2 = mod.decode_step(model, grow_cache(cache, S + 8),
                                     tokens[:, S - 1:S], cfg)
    finally:
        model.cfg = pair[0]
    np.testing.assert_allclose(lg[:, 0].numpy(), logits[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-3)
    assert int(cache2["pos"]) == S - 1


@pytest.mark.parametrize("arch", MOE)
def test_train_step_with_aux_loss_matches_reference(arch):
    """One train step: the aux loss in the loss, AdamW's weight decay on the
    expert stacks, routers and shared experts by the reference's rule."""
    cfg, mod, _, _ = configs(arch)
    b = batch(cfg, np.random.default_rng(6))
    got_m, want_m, got, want, near = train_step_pair(arch, 8, b)
    for key in ("loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=1e-5)
    assert float(got_m["aux_loss"]) > 0
    assert_params_close(got, want, near, max_loose=5e-3)
    mask = decay_mask(mod.param_defs(cfg))
    assert [k for k, v in mask.items() if not v] == ["final_norm"]
    assert mask["moe_layers.0.w_gate"] and mask["moe_layers.2.router.weight"]
    assert mask["moe_layers.1.shared.wd.weight"] \
        == (cfg.n_shared_experts > 0)
    assert list(mask) == [n for _, _, names in port_leaves(
        mod.param_defs(cfg)) for n in names]
