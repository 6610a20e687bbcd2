"""The port's Zamba2 hybrid against the JAX reference, on the CPU, in f32.

zamba2-1.2b at ``reduced()`` (6 SSM layers, the shared block after every
2) and with ``n_layers = 7``, whose last group is incomplete and runs after
the last application (as the full config's 38 = 6 x 6 + 2 layers do):
forward, hidden states, the prefill cache (conv windows and states over
all groups, one KV cache per application), three decode steps, decode
against its own forward, one train step, the parameter hand-over with the
top-level ``shared`` block, and the weight-decay mask.  Inputs are seeded
numpy; the parameters one JAX initialisation handed over with
``params_from_jax``.

Tolerances (f32, the same operations in another order or library): logits,
hidden states and cache entries within ``atol = 1e-4``
(``tests/test_torch_decode.py``'s); decode against forward and the train
step as ``tests/torch_parity.py`` states, with the hybrid's gradient floor
of ``1e-5`` there: 1.02 and 1.05 in 1,000 of its elements fall under it
(measured at both depths), so up to 2 in 1,000 may be held within
``2 lr`` only.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import hybrid as ref_hybrid  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch.models import common, hybrid, registry  # noqa: E402
from torch_parity import (assert_params_close, batch,  # noqa: E402
                          check_decode_matches_forward, check_decode_steps,
                          check_forward, check_params_round_trip,
                          check_prefill, model_pair, train_step_pair)

ARCH = "zamba2-1.2b"
ATOL = 1e-4
DEPTHS = [6, 7]   # reduced(); one more layer: an incomplete tail group


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda n: f"L{n}")
def pair(request):
    return model_pair(ARCH, seed=request.param, n_layers=request.param)


def test_groups_match_reference():
    """Every depth from 1 to 2 groups past the full config's, and the full
    config itself: 6 applications, the last group of 2 layers incomplete."""
    full, _ = registry.get(ARCH)
    assert hybrid._groups(full) == ref_hybrid._groups(full)
    assert hybrid._groups(full)[-1] == (36, 38, False)
    assert hybrid.n_applications(full) == 6
    for n in range(1, 40):
        cfg = dataclasses.replace(full, n_layers=n)
        assert hybrid._groups(cfg) == ref_hybrid._groups(cfg)
        assert hybrid.n_applications(cfg) == ref_hybrid.n_applications(cfg)


@pytest.mark.parametrize("S", [16, 13])
def test_forward_and_hidden_match_reference(pair, S):
    check_forward(pair, S, ATOL)


def test_prefill_cache_matches_reference(pair):
    cfg = pair[0]
    cache = check_prefill(pair, 13, ATOL)
    napp = hybrid.n_applications(cfg)
    assert tuple(cache["k"].shape) == (napp, 2, 13, cfg.n_kv_heads,
                                       cfg.head_dim)
    assert cache["conv"].shape[0] == cache["state"].shape[0] == cfg.n_layers


def test_decode_steps_match_reference(pair):
    check_decode_steps(pair, 16, ATOL)


def test_decode_matches_forward(pair):
    check_decode_matches_forward(pair, 16)


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_train_step_matches_reference(n_layers):
    cfg = model_pair(ARCH, 0, n_layers=n_layers)[0]
    b = batch(cfg, np.random.default_rng(5))
    got_m, want_m, got, want, near = train_step_pair(
        ARCH, 9, b, g_floor=1e-5, n_layers=n_layers)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    assert np.isfinite(float(got_m["grad_norm"]))
    assert_params_close(got, want, near, max_loose=2e-3)


def test_params_round_trip_and_decay_mask():
    """The ``shared`` subtree maps to the ``shared`` submodule (one block,
    no layers axis): its projections are decayed, its 1-D norms are not;
    every stacked SSM leaf is decayed."""
    state, mask = check_params_round_trip(ARCH, 2)
    cfg = model_pair(ARCH, 2)[0]
    H, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    assert tuple(state["shared.wq.weight"].shape) == (H * hd, d)
    assert not any(k.startswith("shared.0.") for k in state)
    assert not mask["shared.ln1"] and not mask["shared.ln2"]
    assert mask["shared.wq.weight"] and mask["shared.wd.weight"]
    assert all(mask[f"layers.{i}.{n}"] for i in range(cfg.n_layers)
               for n in ("A_log", "D", "dt_bias", "ln", "out_norm"))
    assert sorted(k for k, v in mask.items() if not v) == [
        "final_norm", "shared.ln1", "shared.ln2"]


def test_cache_defs_match_reference():
    """The full config's decode cache at the ``long_500k`` shape: the same
    shapes as the reference's, and the KV caches are the only entries that
    grow with the sequence."""
    full, _ = registry.get(ARCH)
    rfull, _ = ref_registry.get(ARCH)
    S = 524_288
    got = hybrid.cache_defs(full, 1, S)
    want = ref_hybrid.cache_defs(rfull, 1, S)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert got["k"].shape == (6, 1, S, 32, 64)
    abstract = {k: torch.empty(v.shape, device="meta")
                for k, v in got.items()}
    grown = common.grow_cache(abstract, S + 16)
    assert [k for k in got if grown[k].shape != abstract[k].shape] == \
        ["k", "v"]
