"""The port's dense transformer family and its decode path against the JAX
reference, on the CPU, at each config's ``reduced()`` in f32.

smollm-360m and the five dense configs (qwen3-4b with qk_norm, qwen2-72b
and qwen2.5-32b with QKV bias, the musicgen-large and internvl2-76b
backbones with their ``embeds`` prefix) start in both packages from one
JAX initialisation, handed over with ``params_from_jax``; inputs are
seeded numpy.

Tolerances (f32, the same operations in another order or library):
logits, hidden states and cache tensors within ``atol = 1e-4``
(``tests/test_torch_models.py``'s); ``attn_decode`` and ``update_cache``
within ``rtol = atol = 1e-5``; the port's decode against its own forward
within the reference test's ``rtol = 2e-2, atol = 2e-3``
(``tests/test_models_smoke.py::test_decode_matches_forward``); one train
step as ``tests/torch_parity.py`` states.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.common import grow_cache  # noqa: E402
from torch_parity import (as_numpy, assert_params_close, batch,  # noqa: E402
                          cache_numpy, configs, grow, reference_params,
                          train_step_pair)

DENSE = ["smollm-360m", "qwen3-4b", "qwen2-72b", "qwen2.5-32b",
         "musicgen-large", "internvl2-76b"]
ATOL = 1e-4
B, S = 2, 16


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """``(cfg, port module, port model, reference module, reference
    params)`` for one architecture."""
    arch = request.param
    cfg, mod, rmod, rcfg = configs(arch)
    params = reference_params(rmod, rcfg, seed=DENSE.index(arch))
    model = mod.build(cfg, as_numpy(params), device="cpu")
    return cfg, mod, model, rmod, params


def _tokens(cfg, seed, n=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, n)).astype(np.int32)


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def test_forward_logits_match_reference(pair):
    cfg, mod, model, rmod, params = pair
    b = batch(cfg, np.random.default_rng(1))
    del b["labels"]
    got = mod.forward(model, _torch(b), cfg)
    want = rmod.forward(params, _jax(b), cfg)
    assert got.shape == (B, S, cfg.vocab_padded())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_prefill_cache_matches_reference(pair):
    cfg, mod, model, rmod, params = pair
    tokens = _tokens(cfg, 2, S - 1)
    lg, cache = mod.forward(model, {"tokens": torch.as_tensor(tokens)}, cfg,
                            return_cache=True)
    rlg, rcache = rmod.forward(params, {"tokens": jnp.asarray(tokens)}, cfg,
                               return_cache=True)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=0,
                               atol=ATOL)
    assert set(cache) == set(rcache) == {"k", "v", "pos"}
    shape = (cfg.n_layers, B, S - 1, cfg.n_kv_heads, cfg.head_dim)
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]),
                                   rtol=0, atol=ATOL)
    assert cache["pos"].dtype == torch.int32
    assert int(cache["pos"]) == int(rcache["pos"]) == S - 2


def test_decode_step_matches_reference(pair):
    """Three decode steps on the same grown cache: logits and the updated
    cache after each step against the reference's ``decode_step``."""
    cfg, mod, model, rmod, params = pair
    tokens = _tokens(cfg, 3, S + 2)
    _, rcache = rmod.forward(params, {"tokens": jnp.asarray(tokens[:, :S])},
                             cfg, return_cache=True)
    rcache = grow(cache_numpy(rcache), S + 8)
    cache = {k: torch.tensor(v) for k, v in rcache.items()}
    rcache = {k: jnp.asarray(v) for k, v in rcache.items()}
    for t in range(S, S + 3):
        step = tokens[:, t - 1:t] if t < S + 2 else tokens[:, -1:]
        lg, cache = mod.decode_step(model, cache, torch.as_tensor(step), cfg)
        rlg, rcache = rmod.decode_step(params, rcache, jnp.asarray(step),
                                       cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=0,
                                   atol=ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(rcache[k]), rtol=0,
                                       atol=ATOL)
        assert int(cache["pos"]) == int(rcache["pos"]) == t


def test_decode_matches_forward(pair):
    """The reference's check, on the port: ``decode_step`` after a prefill
    of S-1 tokens gives ``forward``'s logits at position S-1."""
    cfg, mod, model, _, _ = pair
    tokens = torch.as_tensor(_tokens(cfg, 4))
    logits = mod.forward(model, {"tokens": tokens}, cfg)
    _, cache = mod.forward(model, {"tokens": tokens[:, :S - 1]}, cfg,
                           return_cache=True)
    lg, cache2 = mod.decode_step(model, grow_cache(cache, S + 8),
                                 tokens[:, S - 1:S], cfg)
    np.testing.assert_allclose(lg[:, 0].numpy(), logits[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-3)
    assert int(cache2["pos"]) == S - 1


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-76b"])
def test_modality_train_step_matches_reference(arch):
    """One train step with the ``embeds`` prefix and ``-1`` labels of
    ``tests/test_models_smoke.py:_batch``."""
    cfg, _, _, _ = configs(arch)
    b = batch(cfg, np.random.default_rng(5))
    assert "embeds" in b and (b["labels"][:, :4] == -1).all()
    got_m, want_m, got, want, near = train_step_pair(arch, 7, b)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    assert_params_close(got, want, near)


def _qkv(H, Hkv, dh, Sc, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(B, 1, H, dh)).astype(f),
            rng.normal(size=(B, Sc, Hkv, dh)).astype(f),
            rng.normal(size=(B, Sc, Hkv, dh)).astype(f),
            rng.normal(size=(B, 1, Hkv, dh)).astype(f),
            rng.normal(size=(B, 1, Hkv, dh)).astype(f))


@pytest.mark.parametrize("self_term", [True, False])
@pytest.mark.parametrize("pos", [0, 5, 11])
@pytest.mark.parametrize("form,H,Hkv,group", [
    ("grouped", 6, 2, 3), ("expanded", 6, 2, 2), ("none", 6, 2, None),
    ("mha", 4, 4, None)])
def test_attn_decode_matches_reference(form, H, Hkv, group, pos, self_term):
    """Grouped (``H == Hkv * group_size``), expanded (a group size that
    does not tile the heads, and ``group_size=None``) and plain multi-head,
    with ``pos`` at 0, in the middle and at S-1 of a 12-long cache."""
    q, kc, vc, kn, vn = _qkv(H, Hkv, 8, 12, seed=H + pos)
    extra = (kn, vn) if self_term else (None, None)
    got = layers.attn_decode(
        *(torch.as_tensor(a) for a in (q, kc, vc)), torch.tensor(pos),
        *(None if a is None else torch.as_tensor(a) for a in extra),
        group_size=group)
    want = ref_layers.attn_decode(
        *(jnp.asarray(a) for a in (q, kc, vc)), jnp.int32(pos),
        *(None if a is None else jnp.asarray(a) for a in extra),
        group_size=group)
    assert got.shape == (B, 1, H, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seq_axis,pos", [(1, 0), (1, 7), (2, 3)])
def test_update_cache_matches_reference(seq_axis, pos):
    rng = np.random.default_rng(pos)
    shape = (3, 2, 8, 4) if seq_axis == 2 else (2, 8, 4)
    cache = rng.normal(size=shape).astype(np.float32)
    new_shape = list(shape)
    new_shape[seq_axis] = 1
    new = rng.normal(size=new_shape).astype(np.float32)
    want = ref_layers.update_cache(jnp.asarray(cache), jnp.asarray(new),
                                   jnp.int32(pos), seq_axis=seq_axis)
    t = torch.as_tensor(cache.copy())
    got = layers.update_cache(t, torch.as_tensor(new), torch.tensor(pos),
                              seq_axis=seq_axis)
    assert got.data_ptr() == t.data_ptr()  # written in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
