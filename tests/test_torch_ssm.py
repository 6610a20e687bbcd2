"""The port's Mamba2 family against the JAX reference, on the CPU, in f32.

Units of ``models/layers.py``: ``causal_conv1d`` (whole sequence and the
streaming cache), ``ssd_step``, and ``ssd_chunked`` against the reference
and against a loop of ``ssd_step``.  At ``ssm_chunk = 128`` over 256 steps
the reference's ``ssd_chunked`` has a NaN gradient (it exponentiates the
positive upper triangle of the within-chunk decay, which overflows, and
discards it after); the port's is finite and equals a copy of the
reference written here with the exponent masked first.  Then mamba2-370m
at ``reduced()``: forward, hidden states, the prefill cache, three decode
steps, decode against its own forward, one train step, the parameter
hand-over and its weight-decay mask, and ``embed_windows`` with the
``embedding`` index over its hidden states; inputs are seeded numpy and
the parameters one JAX initialisation handed over with
``params_from_jax``.

Tolerances (f32, the same operations in another order or library): the
layer units within ``rtol = atol = 1e-5``; the chunked scan within
``rtol = 1e-4, atol = 1e-5`` and its gradient (entries of order 1, each a
sum over up to 256 steps) within ``rtol = atol = 1e-4``, the products
summed in another order; logits, hidden states and cache entries within
``atol = 1e-4`` (``tests/test_torch_decode.py``'s); decode against forward
and the train step as ``tests/torch_parity.py`` states; pooled vectors
within ``1e-4``, index answers and counts identical
(``tests/test_torch_embedding.py``'s).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.retrieval as ref  # noqa: E402
from repro.core import embedding_retrieval as ref_er  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.core import embedding_retrieval as er  # noqa: E402
from repro_torch.models import common, layers  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402
from torch_parity import (assert_params_close, batch,  # noqa: E402
                          check_decode_matches_forward, check_decode_steps,
                          check_forward, check_params_round_trip,
                          check_prefill, model_pair, train_step_pair)

ARCH = "mamba2-370m"
ATOL = 1e-4
F32 = np.float32


def _ssd_inputs(seed, B=2, S=32, H=4, P=3, G=2, N=5, dt_mean=None):
    """x, dt (post-softplus), A (negative), Bm, Cm, D as numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(F32)
    if dt_mean is None:
        dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(F32)
    else:
        dt = (dt_mean + 0.1 * rng.normal(size=(B, S, H))).astype(F32)
    A = -np.exp(rng.normal(scale=0.3, size=(H,))).astype(F32)
    Bm = rng.normal(size=(B, S, G, N)).astype(F32)
    Cm = rng.normal(size=(B, S, G, N)).astype(F32)
    D = rng.normal(size=(H,)).astype(F32)
    return x, dt, A, Bm, Cm, D


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH, seed=0)


# -- layer units --------------------------------------------------------------

@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_reference(with_cache):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 10)).astype(F32)
    w = rng.normal(size=(4, 10)).astype(F32)
    cache = rng.normal(size=(2, 3, 10)).astype(F32) if with_cache else None
    got, got_c = layers.causal_conv1d(
        torch.as_tensor(x), torch.as_tensor(w),
        None if cache is None else torch.as_tensor(cache))
    want, want_c = ref_layers.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if cache is None else jnp.asarray(cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert tuple(got_c.shape) == (2, 3, 10)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # streaming: one step at a time from a zero window equals the sequence
    c = torch.zeros(2, 3, 10)
    steps = []
    for t in range(7):
        y, c = layers.causal_conv1d(torch.as_tensor(x[:, t:t + 1]),
                                    torch.as_tensor(w), c)
        steps.append(y)
    if not with_cache:
        np.testing.assert_allclose(torch.cat(steps, 1).numpy(), got.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_ssd_step_matches_reference():
    x, dt, A, Bm, Cm, D = _ssd_inputs(2, S=1)
    h = np.random.default_rng(3).normal(size=(2, 4, 3, 5)).astype(F32)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D, h)
    got_y, got_h = layers.ssd_step(*(torch.as_tensor(a) for a in args))
    want_y, want_h = ref_layers.ssd_step(*(jnp.asarray(a) for a in args))
    assert got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(32, 8), (5, 8), (24, 24)])
def test_ssd_chunked_matches_reference(S, chunk):
    """A chunk multiple, a sequence shorter than one chunk (``c = S``) and
    one chunk exactly."""
    args = _ssd_inputs(4, S=S)
    got_y, got_h = layers.ssd_chunked(*(torch.as_tensor(a) for a in args),
                                      chunk=chunk)
    want_y, want_h = ref_layers.ssd_chunked(*(jnp.asarray(a) for a in args),
                                            chunk=chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("S", [32, 13])
def test_ssd_chunked_matches_a_loop_of_steps(S):
    """The chunked scan equals the recurrence run one step at a time; a
    length that is no chunk multiple is padded with ``dt = 0`` steps (the
    model's rule), which leave the state as it is."""
    x, dt, A, Bm, Cm, D = (torch.as_tensor(a) for a in _ssd_inputs(5, S=S))
    pad = (-S) % 8
    padded = [torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
              for a in (x, dt, Bm, Cm)]
    y, hT = layers.ssd_chunked(padded[0], padded[1], A, padded[2],
                               padded[3], D, chunk=8)
    h = torch.zeros(2, 4, 3, 5)
    ys = []
    for t in range(S):
        yt, h = layers.ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D,
                                h)
        ys.append(yt)
    np.testing.assert_allclose(y[:, :S].numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), h.numpy(), rtol=1e-4, atol=1e-5)


def test_ssd_chunked_refuses_a_ragged_length():
    """Past one chunk, the length must be a chunk multiple (the reference
    asserts it; the model pads)."""
    args = [torch.as_tensor(a) for a in _ssd_inputs(5, S=13)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        layers.ssd_chunked(*args, chunk=8)


def _masked_ssd_chunked(x, dt, A, Bm, Cm, D, chunk):
    """The reference's ``ssd_chunked`` (``src/repro/models/layers.py``)
    with one change: the within-chunk decay's exponent is ``-inf`` above
    the diagonal before the exponential, instead of the product being
    zeroed after it."""
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    c = min(chunk, S)
    nc = S // c
    xs = x.reshape(Bsz, nc, c, H, Pd)
    dts = dt.reshape(Bsz, nc, c, H)
    Bs = jnp.repeat(Bm.reshape(Bsz, nc, c, G, N), rep, axis=3)
    Cs = jnp.repeat(Cm.reshape(Bsz, nc, c, G, N), rep, axis=3)
    cum = jnp.cumsum(dts * A[None, None, :], axis=2)
    seg_end = cum[:, :, -1, :]
    tri = jnp.tril(jnp.ones((c, c), bool))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = jnp.exp(jnp.where(tri[None, None, :, :, None], diff, -jnp.inf))
    cb = jnp.einsum("bkchn,bkshn->bkhcs", Cs, Bs).astype(jnp.float32)
    att = cb * decay.transpose(0, 1, 4, 2, 3)
    xdt = (xs * dts[..., None]).astype(jnp.float32)
    y_intra = jnp.einsum("bkhcs,bkshp->bkchp", att, xdt)
    decay_to_end = jnp.exp(seg_end[:, :, None, :] - cum)
    state_in = jnp.einsum("bkchn,bkchp->bkhpn", Bs,
                          xdt * decay_to_end[..., None])

    def step(h, inp):
        st_in, dec = inp
        return h * jnp.exp(dec)[:, :, None, None] + st_in, h

    hT, h_prev = jax.lax.scan(
        step, jnp.zeros((Bsz, H, Pd, N), jnp.float32),
        (state_in.transpose(1, 0, 2, 3, 4), seg_end.transpose(1, 0, 2)))
    h_prev = h_prev.transpose(1, 0, 2, 3, 4)
    y_inter = jnp.einsum("bkchn,bkhpn->bkchp", Cs, h_prev) \
        * jnp.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    y = y + x.astype(jnp.float32) * D[None, None, :, None]
    return y.astype(x.dtype), hT


def test_ssd_gradient_is_finite_at_the_default_chunk():
    """``ssm_chunk = 128`` (both configs' default), 256 steps, ``dt`` about
    0.8 with ``A`` near -1 (random init's values): the positive exponent
    above the diagonal passes 88.7 within a chunk.  The reference's
    gradient is NaN (an observation of ``repro``, kept true here); the
    port's is finite and equals the masked-exponent copy's; the forward is
    the same in all three."""
    args = _ssd_inputs(6, B=1, S=256, H=2, P=4, G=1, N=4, dt_mean=0.8)
    w = np.random.default_rng(7).normal(size=(1, 256, 2, 4)).astype(F32)
    wh = np.random.default_rng(8).normal(size=(1, 2, 4, 4)).astype(F32)

    def jloss(fn):
        def f(*a):
            y, h = fn(*a, chunk=128)
            return jnp.sum(y * w) + jnp.sum(h * wh)
        return f

    jargs = [jnp.asarray(a) for a in args]
    argnums = tuple(range(6))
    ref_g = jax.grad(jloss(ref_layers.ssd_chunked), argnums)(*jargs)
    assert any(np.isnan(np.asarray(g)).any() for g in ref_g)
    fixed_g = jax.grad(jloss(_masked_ssd_chunked), argnums)(*jargs)
    assert all(np.isfinite(np.asarray(g)).all() for g in fixed_g)

    targs = [torch.tensor(a, requires_grad=True) for a in args]
    y, h = layers.ssd_chunked(*targs, chunk=128)
    (y * torch.as_tensor(w)).sum().add((h * torch.as_tensor(wh)).sum()) \
        .backward()
    for name, t, g in zip("x dt A Bm Cm D".split(), targs, fixed_g):
        assert torch.isfinite(t.grad).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    want_y, want_h = ref_layers.ssd_chunked(*jargs, chunk=128)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_model_gradient_at_the_default_chunk(arch, monkeypatch):
    """Both families at ``reduced()`` with the configs' own chunk of 128,
    one sequence of 256 tokens: the reference's loss gradient is NaN
    (asserted); with the masked-exponent copy patched in for its
    ``ssd_chunked`` it is finite, and the port's gradient equals it leaf by
    leaf within ``rtol = 1e-3`` and ``atol = 1e-4`` of the leaf's largest
    entry (f32 sums over 256 steps, a stack of layers and, in the hybrid,
    256-key attention, in another order: up to 3.0e-5 of the largest
    entry, measured); the losses within ``rtol = 1e-5``."""
    import repro.models.mamba2 as ref_mamba2
    from repro.train import train_state as ref_ts
    from repro_torch.models.params import params_to_jax
    from repro_torch.train import train_state as ts
    from torch_parity import as_numpy, flat

    cfg, mod, model, rmod, params = model_pair(arch, 3, ssm_chunk=128)
    b = batch(cfg, np.random.default_rng(9), B=1, S=256)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def ref_grads():
        return jax.value_and_grad(lambda p: ref_ts.make_loss_fn(rmod, cfg)(
            p, jb)[0])(params)

    _, nan_g = ref_grads()
    assert any(np.isnan(g).any() for g in flat(as_numpy(nan_g)).values())
    monkeypatch.setattr(ref_mamba2, "ssd_chunked", _masked_ssd_chunked)
    want_loss, want_g = ref_grads()
    want = flat(as_numpy(want_g))

    model.requires_grad_(True)
    named = dict(model.named_parameters())
    total, _ = ts.make_loss_fn(mod, cfg)(model, b)
    grads = torch.autograd.grad(total, list(named.values()))
    got = flat(params_to_jax(dict(zip(named, grads)), mod.param_defs(cfg)))
    np.testing.assert_allclose(total.item(), float(want_loss), rtol=1e-5)
    assert set(got) == set(want)
    for k, g in want.items():
        assert np.isfinite(g).all() and np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], g, rtol=1e-3,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


# -- mamba2-370m at reduced() -------------------------------------------------

@pytest.mark.parametrize("S", [16, 13])
def test_forward_and_hidden_match_reference(pair, S):
    """16 tokens are two chunks of 8; 13 are padded to 16 inside."""
    check_forward(pair, S, ATOL)


@pytest.mark.parametrize("S", [16, 13])
def test_prefill_cache_matches_reference(pair, S):
    cfg = pair[0]
    cache = check_prefill(pair, S, ATOL)
    G, N = cfg.ssm_groups, cfg.ssm_state
    assert tuple(cache["conv"].shape) == (
        cfg.n_layers, 2, cfg.ssm_conv - 1, cfg.d_inner + 2 * G * N)
    assert tuple(cache["state"].shape) == (
        cfg.n_layers, 2, cfg.ssm_heads, cfg.ssm_head_dim, N)
    assert cache["state"].dtype == torch.float32


def test_decode_steps_match_reference(pair):
    check_decode_steps(pair, 16, ATOL)


def test_decode_matches_forward(pair):
    check_decode_matches_forward(pair, 16)


def test_train_step_matches_reference():
    cfg = model_pair(ARCH, 0)[0]
    b = batch(cfg, np.random.default_rng(5))
    got_m, want_m, got, want, near = train_step_pair(ARCH, 7, b)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    assert np.isfinite(float(got_m["grad_norm"]))
    assert_params_close(got, want, near)
    assert cfg.remat == "none"


def test_params_round_trip_and_decay_mask():
    """Every SSM leaf hands over and back exactly; the stacked ``A_log``,
    ``D`` and ``dt_bias`` (2-D in the reference's tree) are decayed, the
    final norm is not."""
    state, mask = check_params_round_trip(ARCH, 1)
    cfg = model_pair(ARCH, 1)[0]
    d, di = cfg.d_model, cfg.d_inner
    assert state["layers.0.w_in.weight"].shape[1] == d
    assert tuple(state["layers.0.w_out.weight"].shape) == (d, di)
    assert tuple(state["layers.0.conv_w"].shape) == (cfg.ssm_conv,
                                                     di + 2 * cfg.ssm_state)
    assert all(mask[f"layers.{i}.{n}"] for i in range(cfg.n_layers)
               for n in ("A_log", "D", "dt_bias", "ln", "out_norm"))
    assert [k for k, v in mask.items() if not v] == ["final_norm"]


def test_init_cache_keeps_the_state_in_f32(pair):
    cfg, mod = pair[0], pair[1]
    cache = common.init_cache(mod.cache_defs(cfg, 3, 99), torch.bfloat16)
    assert cache["state"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["pos"].dtype == torch.int32 and cache["pos"].ndim == 0
    assert tuple(cache["conv"].shape)[:3] == (cfg.n_layers, 3,
                                               cfg.ssm_conv - 1)
    # growing leaves the conv window and the state as they are
    grown = common.grow_cache(cache, 200)
    assert all(grown[k] is cache[k] for k in cache)


def test_embed_windows_and_index_match_reference(pair):
    """Pooled windows of the reduced model's hidden states in both
    packages, then the ``embedding`` index over them: the same range and
    nearest answers and the same counts."""
    cfg, mod, model, rmod, params = pair
    rng = np.random.default_rng(6)
    seqs = [rng.integers(0, cfg.vocab, size=(48,)) for _ in range(3)]
    seqs.append(rng.integers(0, cfg.vocab, size=(40,)))
    seqs.append(seqs[0].copy())
    want, want_meta = ref_er.embed_windows(rmod, params, cfg, seqs, window=8)
    got, meta = er.embed_windows(mod, model, cfg, seqs, window=8,
                                 device="cpu")
    assert got.shape == np.asarray(want).shape == (29, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert [(m.seq_id, m.start) for m in meta] == \
        [(m.seq_id, m.start) for m in want_meta]
    index = dict(index="embedding", eps_prime=0.02, num_max=5,
                 tight_bounds=True)
    port = Retriever.build(RetrievalConfig("euclidean", device="cpu",
                                           **index), got)
    exp = ref.Retriever.build(ref.RetrievalConfig("euclidean",
                                                  backend="numpy", **index),
                              got)
    assert port.eval_stats() == exp.eval_stats()
    probes = [got[i] for i in (0, 7, 25, 28)]
    for eps in (1e-4, 0.6, 1.2):
        a, b = port.batch(probes).range(eps), exp.batch(probes).range(eps)
        assert a.hits == b.hits and a.stats == b.stats
    assert 0 in port.query(got[23]).range(1e-4).hits  # seq 4 copies seq 0
    a = port.query(got[26]).nearest(2.0, tol=1e-3)
    b = exp.query(got[26]).nearest(2.0, tol=1e-3)
    assert a.hits == b.hits and a.stats == b.stats
