"""The port's dense transformer against the JAX reference's.

The reduced smollm-360m config (``configs/smollm_360m.py:reduced``) is
initialised by the reference (``jax.random``), handed over with
``params_from_jax`` and run by both packages on the same seeded tokens.

Tolerance: f32 hidden states agree within ``1e-4`` (absolute; both run the
same f32 operations, with products and reductions in another order); in
bf16 within ``2e-2`` of the largest ``|h|`` (the two frameworks round the
bf16 products and residual sums at other places).  ``attn_chunked``'s online
softmax agrees with ``attn_full`` and with the reference's at ``1e-5``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro.models.params import param_count as ref_param_count  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402
from repro_torch.models.params import (init_params, param_count,  # noqa: E402
                                       params_from_jax, params_to_jax)

ARCH = "smollm-360m"


def reference(cfg, seed=0, dtype=jnp.float32):
    _, mod = ref_registry.get(ARCH, reduced=True)
    return mod, ref_init(mod.param_defs(cfg), jax.random.PRNGKey(seed), dtype)


def as_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def hidden_pair(cfg, tokens, *, seed=0, jdtype=jnp.float32,
                tdtype=torch.float32):
    ref_mod, params = reference(cfg, seed, jdtype)
    _, mod = registry.get(ARCH, reduced=True)
    model = mod.build(cfg, as_numpy(params), dtype=tdtype, device="cpu")
    want = ref_mod.forward(params, {"tokens": jnp.asarray(tokens)}, cfg,
                           return_hidden=True)
    got = mod.forward(model, {"tokens": torch.as_tensor(tokens)}, cfg,
                      return_hidden=True)
    return (got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)))


def tokens_for(cfg, B=2, S=24, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def test_registry_and_configs_match_reference():
    for reduced in (False, True):
        cfg, mod = registry.get(ARCH, reduced=reduced)
        want, ref_mod = ref_registry.get(ARCH, reduced=reduced)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert param_count(mod.param_defs(cfg)) == ref_param_count(
            ref_mod.param_defs(want))
    assert registry.names() == ref_registry.names()


def test_params_from_jax_round_trips_every_leaf():
    cfg, mod = registry.get(ARCH, reduced=True)
    _, params = reference(cfg)
    tree = as_numpy(params)
    state = params_from_jax(tree)
    model = mod.build(cfg, tree, device="cpu")
    assert set(state) == set(model.state_dict())
    back = params_to_jax(model.state_dict(), mod.param_defs(cfg))
    flat, treedef = jax.tree.flatten(tree)
    flat_back, treedef_back = jax.tree.flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)
    # the heads-split layouts land in nn.Linear's (out, in)
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    assert state["layers.0.wq.weight"].shape == (H * hd, d)
    assert state["layers.1.wo.weight"].shape == (d, H * hd)
    np.testing.assert_array_equal(
        state["layers.1.wo.weight"].numpy(),
        tree["layers"]["wo"][1].reshape(H * hd, d).T)


def test_init_params_fan_in_rule():
    cfg, mod = registry.get(ARCH, reduced=True)
    defs = mod.param_defs(cfg)
    g = torch.Generator().manual_seed(0)
    p = init_params(defs, g, torch.float32)
    assert p["layers"]["ln1"].eq(1).all() and p["final_norm"].eq(1).all()
    wq = p["layers"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    again = init_params(defs, torch.Generator().manual_seed(0), torch.float32)
    assert torch.equal(again["tok"], p["tok"])
    assert init_params(defs, g)["tok"].dtype == torch.bfloat16


def test_forward_hidden_f32_matches_reference():
    cfg, _ = registry.get(ARCH, reduced=True)
    got, want = hidden_pair(cfg, tokens_for(cfg))
    assert got.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_logits_f32_match_reference():
    cfg, mod = registry.get(ARCH, reduced=True)
    ref_mod, params = reference(cfg, seed=2)
    tokens = tokens_for(cfg, B=1, S=16, seed=3)
    model = mod.build(cfg, as_numpy(params), device="cpu")
    got = mod.forward(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    want = ref_mod.forward(params, {"tokens": jnp.asarray(tokens)}, cfg)
    assert got.shape == (1, 16, cfg.vocab_padded())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_forward_hidden_bf16_matches_reference():
    cfg, _ = registry.get(ARCH, reduced=True)
    got, want = hidden_pair(cfg, tokens_for(cfg, seed=4), jdtype=jnp.bfloat16,
                            tdtype=torch.bfloat16)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("flag", ["qkv_bias", "qk_norm"])
def test_forward_branches_match_reference(flag):
    base, _ = registry.get(ARCH, reduced=True)
    cfg = dataclasses.replace(base, **{flag: True})
    ref_mod, params = reference(cfg, seed=5)
    if flag == "qkv_bias":  # zeros at init: make the branch do something
        rng = np.random.default_rng(6)
        for b in ("bq", "bk", "bv"):
            shape = params["layers"][b].shape
            params["layers"][b] = jnp.asarray(
                rng.normal(scale=0.5, size=shape), jnp.float32)
    _, mod = registry.get(ARCH, reduced=True)
    model = mod.build(cfg, as_numpy(params), device="cpu")
    tokens = tokens_for(cfg, seed=7)
    got = mod.forward(model, {"tokens": torch.as_tensor(tokens)}, cfg,
                      return_hidden=True).numpy()
    want = np.asarray(ref_mod.forward(params, {"tokens": jnp.asarray(tokens)},
                                      cfg, return_hidden=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_long_sequence_takes_chunked_attention(monkeypatch):
    """Past the full-attention limit the forward runs ``attn_chunked``,
    and agrees with the reference's chunked schedule."""
    from repro_torch.models import transformer
    base, mod = registry.get(ARCH, reduced=True)
    cfg = dataclasses.replace(base, attn_chunk=8, n_layers=2)
    ref_mod, params = reference(cfg, seed=8)
    model = mod.build(cfg, as_numpy(params), device="cpu")
    tokens = tokens_for(cfg, B=1, S=32, seed=9)
    want = mod.forward(model, {"tokens": torch.as_tensor(tokens)}, cfg,
                       return_hidden=True).numpy()
    monkeypatch.setattr(transformer, "FULL_ATTN_MAX", 16)
    got = mod.forward(model, {"tokens": torch.as_tensor(tokens)}, cfg,
                      return_hidden=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def qkv(B, S, H, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, dh)).astype(np.float32)
            for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [4, 8])
def test_attn_chunked_matches_full_and_reference(causal, chunk):
    q, k, v = qkv(2, 32, 6, 2, 8, seed=chunk)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = layers.attn_chunked(tq, tk, tv, q_chunk=chunk, kv_chunk=chunk,
                              causal=causal, group_size=3).numpy()
    full = layers.attn_full(tq, tk, tv, causal=causal, group_size=3).numpy()
    want = np.asarray(ref_layers.attn_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=chunk,
        kv_chunk=chunk, causal=causal, group_size=3))
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(full, np.asarray(ref_layers.attn_full(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        group_size=3)), rtol=1e-5, atol=1e-5)


def test_norm_rope_mlp_match_reference():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    w = rng.normal(size=(8,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.as_tensor(x), torch.as_tensor(w)).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(5)[None, :]
    cos, sin = layers.rope_tables(torch.as_tensor(pos), 8, 1e6)
    jcos, jsin = ref_layers.rope_tables(jnp.asarray(pos), 8, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(
        layers.apply_rope(torch.as_tensor(x), cos, sin).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), jcos, jsin)),
        atol=1e-5)
    wg, wu = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(16, 8)).astype(np.float32)
    got = layers.gated_mlp(torch.as_tensor(x), *(torch.as_tensor(a.T.copy())
                                                 for a in (wg, wu, wd)))
    want = ref_layers.gated_mlp({"wg": wg, "wu": wu, "wd": wd},
                                jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
