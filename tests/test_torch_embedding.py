"""The port's embedding-retrieval path against the JAX reference's.

``embed_windows`` over the reduced smollm-360m config (reference weights
handed over with ``params_from_jax``), then the facade's ``embedding``
index built over the same vectors in both packages.  The port runs on the
CPU, where its ``kernel`` backend evaluates the elementwise Euclidean in
torch; the reference runs its numpy backend and its kernel registry
(``backend="pallas"``, whose Euclidean is elementwise jnp).

Tolerance: pooled vectors agree within ``1e-4`` in f32 (the forward's own
tolerance; pooling and normalising add a few ulps).  Index hits, nearest
answers and ``{query, build}`` evaluation and dispatch counts are identical
on the same vectors; Euclidean distances agree within ``1e-5``.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.retrieval as ref  # noqa: E402
from repro.core import embedding_retrieval as ref_er  # noqa: E402
from repro.kernels import registry as ref_kernels  # noqa: E402
from repro.models import registry as ref_models  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro_torch.core import embedding_retrieval as er  # noqa: E402
from repro_torch.kernels import registry as kernels  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

STAT_KEYS = ("query", "build", "dispatches", "build_dispatches")
INDEX = dict(index="embedding", eps_prime=0.02, num_max=5, tight_bounds=True)


@pytest.fixture(scope="module")
def embedded():
    """Both packages' pooled windows of five token sequences (one of them a
    copy of sequence 0, one of another length) under the same weights."""
    cfg, ref_mod = ref_models.get("smollm-360m", reduced=True)
    params = ref_init(ref_mod.param_defs(cfg), jax.random.PRNGKey(4),
                      jnp.float32)
    _, mod = models.get("smollm-360m", reduced=True)
    model = mod.build(cfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(6)
    seqs = [rng.integers(0, cfg.vocab, size=(48,)) for _ in range(3)]
    seqs.append(rng.integers(0, cfg.vocab, size=(40,)))
    seqs.append(seqs[0].copy())
    want, want_meta = ref_er.embed_windows(ref_mod, params, cfg, seqs,
                                           window=8)
    got, meta = er.embed_windows(mod, model, cfg, seqs, window=8,
                                 device="cpu")
    return dict(cfg=cfg, mod=mod, model=model, seqs=seqs, got=got,
                meta=meta, want=want, want_meta=want_meta)


def test_embed_windows_matches_reference(embedded):
    got, want = embedded["got"], embedded["want"]
    assert got.dtype == np.float32 and got.shape == want.shape == (29, 60)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert [(m.seq_id, m.start, m.length) for m in embedded["meta"]] == \
        [(m.seq_id, m.start, m.length) for m in embedded["want_meta"]]
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_embed_windows_stride_and_raw_vectors(embedded):
    cfg, mod, model = embedded["cfg"], embedded["mod"], embedded["model"]
    seqs = embedded["seqs"][:2] + [embedded["seqs"][0][:5]]  # one too short
    got, meta = er.embed_windows(mod, model, cfg, seqs, window=8, stride=4,
                                 normalize=False, device="cpu")
    assert [(m.seq_id, m.start) for m in meta][:3] == [(0, 0), (0, 4), (0, 8)]
    assert len(meta) == 2 * 11 and {m.seq_id for m in meta} == {0, 1}
    hidden = mod.forward(model, {"tokens": torch.as_tensor(seqs[1][None])},
                         cfg, return_hidden=True)[0].numpy()
    np.testing.assert_allclose(got[12], hidden[4:12].mean(0), atol=1e-6)
    # the default device is the card: without one that raises, and with
    # one the model's parameters (here on the CPU) are not there
    err = ((ValueError, "parameters are on cpu") if torch.cuda.is_available()
           else (RuntimeError, "cuda"))
    with pytest.raises(err[0], match=err[1]):
        er.embed_windows(mod, model, cfg, seqs, window=8)


@pytest.mark.parametrize("ref_backend", ["numpy", "pallas"])
def test_embedding_index_matches_reference(embedded, ref_backend):
    """Built over the same vectors: identical range / nearest answers and
    identical evaluation and dispatch counts."""
    vecs, meta = embedded["got"], embedded["meta"]
    port = Retriever.build(RetrievalConfig("euclidean", device="cpu",
                                           **INDEX), vecs)
    want = ref.Retriever.build(ref.RetrievalConfig(
        "euclidean", backend=ref_backend, **INDEX), vecs)
    assert port.eval_stats() == want.eval_stats()
    probe = next(i for i, m in enumerate(meta) if m.seq_id == 4)
    for eps in (1e-4, 0.5, 1.2):
        got, exp = port.query(vecs[probe]).range(eps), \
            want.query(vecs[probe]).range(eps)
        assert got.hits == exp.hits
        assert {k: got.stats[k] for k in STAT_KEYS} == \
            {k: exp.stats[k] for k in STAT_KEYS}
    twin = next(i for i, m in enumerate(meta)
                if m.seq_id == 0 and m.start == meta[probe].start)
    assert twin in port.query(vecs[probe]).range(1e-4).hits
    batch = [vecs[i] for i in (0, 5, probe, 20)]
    got, exp = port.batch(batch).range(0.8), want.batch(batch).range(0.8)
    assert got.hits == exp.hits and got.stats == exp.stats
    got = port.query(vecs[probe]).nearest(2.0, tol=1e-3)
    exp = want.query(vecs[probe]).nearest(2.0, tol=1e-3)
    assert got.hits == exp.hits and got.stats == exp.stats
    np.testing.assert_allclose(got.distances, exp.distances, atol=1e-5)
    assert got.distances[0] <= 1e-3


def test_embedding_config_and_shim(embedded):
    with pytest.raises(ValueError, match="set lam=None"):
        RetrievalConfig("euclidean", lam=8, index="embedding", device="cpu")
    with pytest.raises(ValueError, match="embedding index expects"):
        Retriever.build(RetrievalConfig("euclidean", device="cpu", **INDEX),
                        np.zeros((4, 3, 2), np.float32))
    vecs, meta = embedded["got"], embedded["meta"]
    with pytest.warns(DeprecationWarning, match="EmbeddingRetriever"):
        shim = er.EmbeddingRetriever(vecs, meta, eps_prime=0.02,
                                     device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_er.EmbeddingRetriever(vecs, embedded["want_meta"],
                                         eps_prime=0.02)
    probe = next(i for i, m in enumerate(meta) if m.seq_id == 4)
    assert [i for _, i in shim.query(vecs[probe], 1e-4)] == \
        [i for _, i in want.query(vecs[probe], 1e-4)]
    (win, d), (want_win, want_d) = shim.nearest(vecs[probe]), \
        want.nearest(vecs[probe])
    assert win.seq_id in (0, 4) and d <= 1e-3
    assert (win.seq_id, win.start) == (want_win.seq_id, want_win.start)
    assert shim.retriever.eval_stats() == want.retriever.eval_stats()


def test_euclidean_at_embedding_width_is_one_reduction(monkeypatch):
    """d = 960: the elementwise Euclidean of the kernel registry (and of
    the ``torch`` distance backend) agrees with the reference's and sums
    the feature axis in a fixed number of vectorised adds, not one add per
    feature: numpy's pairwise order (which it now equals bit for bit)
    takes 24 a call at d = 960, 14 block adds and 3 tree levels over the
    eight leaves of 120 terms at once and 7 joining the leaves."""
    from repro.distances import np_backend
    from repro_torch.distances import get
    rng = np.random.default_rng(9)
    xs = rng.normal(size=(33, 1, 960)).astype(np.float32)
    ys = xs + rng.normal(scale=0.05, size=xs.shape).astype(np.float32)
    ys[::4] = rng.normal(size=ys[::4].shape)
    want = ref_kernels.get("euclidean").batch(xs, ys, eps=3.0)
    adds = []
    real_add = torch.Tensor.__add__
    monkeypatch.setattr(torch.Tensor, "__add__",
                        lambda a, b: adds.append(1) or real_add(a, b))
    got = kernels.get("euclidean").batch(xs, ys, eps=3.0, device="cpu")
    direct = get("euclidean").batch(xs, ys, device="cpu")
    monkeypatch.undo()
    assert len(adds) <= 2 * 24
    exact = np_backend.batch_euclidean(xs, ys)
    np.testing.assert_array_equal(direct.numpy(), exact)
    np.testing.assert_array_equal(got.dist.numpy()[got.hit.numpy()],
                                  exact[got.hit.numpy()])
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    assert 0 < int(got.hit.sum()) < 33
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist),
                               rtol=1e-5)
    np.testing.assert_allclose(
        direct.numpy(), np.sqrt(((xs - ys) ** 2).sum((1, 2))), rtol=1e-5)
