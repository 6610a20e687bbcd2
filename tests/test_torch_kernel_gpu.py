"""The hand-written CUDA kernels (wavefront, pairwise L2) against their
plain torch versions, on the card (skipped without one).

Imports only the port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py

Tolerance: Levenshtein distances bit-equal (tokens as int32 ids in f32
storage, compared as integers); float modes ``rtol = atol =
1e-5`` (the two versions run the same f32 operations in the same order;
the plain version's run as separate CUDA kernels); hit and prune masks
equal.  Pairwise L2: squared distances within ``(9d + 26 + 6d 2^-8) 2^-24
(|x|^2 + |y|^2)``, the worst case of the kernel's 3xTF32 products against
the f32 plain version, derived in ``csrc/pairwise_l2.cu``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import pairwise_l2 as pl2  # noqa: E402
from repro_torch.kernels import wavefront as wf  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _ragged(string, B, Lx, Ly, rng, d, dev, nonzero=False):
    """The kernel's operands: rows as they are (``nonzero``: seeded
    non-zero content past each row's lengths), lengths ``(B, 2)``."""
    lx = rng.integers(1, Lx + 1, B)
    ly = rng.integers(1, Ly + 1, B)
    lx[0], ly[0] = Lx, Ly  # the dispatch's widths are the row maxima
    if string:
        xs = rng.integers(0, 6, size=(B, Lx)).astype(np.int32)
        ys = rng.integers(0, 6, size=(B, Ly)).astype(np.int32)
    else:
        xs = rng.normal(size=(B, Lx, d)).astype(np.float32)
        ys = rng.normal(size=(B, Ly, d)).astype(np.float32)
    if not nonzero:
        for i in range(B):
            xs[i, lx[i]:] = 0
            ys[i, ly[i]:] = 0
    lens = torch.as_tensor(np.stack([lx, ly], 1).astype(np.int32),
                           device=dev)
    if string:  # int32 ids, as the registry hands them over
        return [wf.lev_operand(xs, dev), wf.lev_operand(ys, dev), lens]
    return [torch.as_tensor(a, device=dev) for a in (xs, ys)] + [lens]


@pytest.mark.gpu
@pytest.mark.parametrize("nonzero", [False, True])
@pytest.mark.parametrize("mode,B,Lx,Ly,d", [
    ("lev", 257, 22, 20, 1), ("erp", 129, 13, 9, 2), ("dtw", 64, 100, 80, 3),
    ("dfd", 33, 40, 31, 2), ("erp", 2, 1100, 1000, 2)])
def test_cuda_kernel_matches_plain_version(cuda_device, mode, B, Lx, Ly, d,
                                           nonzero):
    rng = np.random.default_rng(B)
    ops = _ragged(mode == "lev", B, Lx, Ly, rng, d, cuda_device, nonzero)
    inf = torch.full((B,), float("inf"), device=cuda_device)
    exact = wf.wavefront_torch(*ops, inf, mode=mode)[0]
    eps = torch.quantile(exact, 0.5).expand(B).contiguous()
    before = wf.LAUNCHES
    got = wf.wavefront_cuda(*ops, eps, mode=mode)
    want = wf.wavefront_torch(*ops, eps, mode=mode)
    torch.cuda.synchronize()
    assert wf.LAUNCHES == before + 1
    if mode == "lev":
        assert torch.equal(got[0], want[0])
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[1].any() and (~got[1]).any()


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    xs, ys, lens = _ragged(True, 4, 6, 6, np.random.default_rng(0), 1,
                           cuda_device)
    eps = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        wf.wavefront_cuda(xs, ys, lens, eps.double(), mode="lev")
    with pytest.raises(ValueError, match="dtype"):
        wf.wavefront_cuda(xs.long(), ys.long(), lens, eps, mode="lev")
    with pytest.raises(ValueError, match="dtype"):  # never reinterpreted
        wf.wavefront_cuda(xs.float(), ys.float(), lens, eps, mode="lev")
    with pytest.raises(ValueError, match="contiguous"):
        wf.wavefront_cuda(xs, ys.T.contiguous().T, lens, eps, mode="lev")
    with pytest.raises(ValueError, match="shape"):
        wf.wavefront_cuda(xs, ys, lens[:3], eps, mode="lev")


@pytest.mark.gpu
def test_counted_dispatches_are_kernel_launches(cuda_device):
    """On the card every counted dispatch of the kernel backend is exactly
    one kernel launch."""
    from repro_torch.data.synthetic import protein_sequences
    from repro_torch.retrieval import RetrievalConfig, Retriever
    seqs = protein_sequences(4, 160, n_motifs=32, seed=3)
    before = wf.LAUNCHES
    r = Retriever.build(RetrievalConfig("levenshtein", lam=16,
                                        tight_bounds=True, num_max=5),
                        seqs)
    rs = r.query(seqs[1][20:70]).range(2.0)
    st = r.eval_stats()
    assert rs.hits
    assert wf.LAUNCHES - before == st["build_dispatches"] + st["dispatches"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["2**24", "2**31-1"])
def test_large_levenshtein_ids_are_exact_on_the_card(cuda_device, case):
    """Token ids that f32 rounds together count as distinct on the card:
    through the counter's default (``kernel``) backend, 4.0 as the numpy
    backend gives, and the kernel bit-equal to its plain version on ids
    spread over the whole of int32 (some of whose bit patterns are NaNs as
    floats)."""
    from repro_torch.core.counter import CountedDistance
    from repro_torch.distances import get
    base = (1 << 24) if case == "2**24" else (1 << 31) - 8
    x = np.array([base + 2 * i for i in range(4)], np.int64)
    y = x + 1
    data = np.stack([x, y])
    before = wf.LAUNCHES
    got = CountedDistance(get("levenshtein"), data,
                          device=cuda_device).eval(x, [1])
    want = CountedDistance(get("levenshtein"), data,
                           backend="numpy").eval(x, [1])
    assert wf.LAUNCHES == before + 1
    assert float(got[0]) == float(want[0]) == 4.0
    rng = np.random.default_rng(7)
    B, L = 96, 12
    ids = rng.integers(-(1 << 31), 1 << 31, size=(B, L), dtype=np.int64)
    ys = np.where(rng.random((B, L)) < 0.5, ids, ids ^ 1)
    xs_t = wf.lev_operand(ids, cuda_device)
    ys_t = wf.lev_operand(ys, cuda_device)
    assert torch.isnan(xs_t.view(torch.float32)).any()
    lens = torch.full((B, 2), L, dtype=torch.int32, device=cuda_device)
    eps = torch.full((B,), 6.0, device=cuda_device)
    got = wf.wavefront_cuda(xs_t, ys_t, lens, eps, mode="lev")
    want = wf.wavefront_torch(xs_t, ys_t, lens, eps, mode="lev")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].any() and (~got[1]).any()


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,d", [(1, 1, 3), (37, 51, 19), (130, 5, 33),
                                   (65, 67, 1), (70, 3, 961),
                                   (200, 300, 960)])
def test_pairwise_l2_kernel_matches_plain_version(cuda_device, M, N, d):
    rng = np.random.default_rng(M + N + d)
    x = torch.as_tensor(rng.normal(size=(M, d)).astype(np.float32),
                        device=cuda_device)
    y = torch.as_tensor(rng.normal(size=(N, d)).astype(np.float32),
                        device=cuda_device)
    y[:min(M, N) // 2] = x[:min(M, N) // 2]  # exact twins: D = 0
    before = pl2.LAUNCHES
    got = pl2.pairwise_l2(x, y)
    want = pl2.pairwise_l2_torch(x, y)
    torch.cuda.synchronize()
    assert pl2.LAUNCHES == before + 1
    assert got.shape == (M, N) and torch.isfinite(got).all()
    bound = (9 * d + 26 + 6 * d * 2.0 ** -8) * 2.0 ** -24 * (
        (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :])
    assert ((got.double() ** 2 - want.double() ** 2).abs()
            <= bound.double()).all()


@pytest.mark.gpu
def test_pairwise_l2_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    x = torch.zeros((4, 6), device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        pl2.pairwise_l2_cuda(x.double(), x)
    with pytest.raises(ValueError, match="contiguous"):
        pl2.pairwise_l2_cuda(x, torch.zeros((6, 4), device=cuda_device).T)
    with pytest.raises(ValueError, match="widths"):
        pl2.pairwise_l2_cuda(x, x[:, :5].contiguous())
    with pytest.raises(ValueError, match="shape"):
        pl2.pairwise_l2_cuda(x[0], x)
    with pytest.raises(ValueError, match="expected cuda"):
        pl2.pairwise_l2_cuda(x, x.cpu())
    before = pl2.LAUNCHES
    assert pl2.pairwise_l2_cuda(x[:0], x).shape == (0, 4)
    assert pl2.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dtw", "erp", "frechet"])
def test_envelope_spec_on_the_card_matches_the_cpu(cuda_device, name):
    """The ``lb:`` envelope specs are torch ops: the same bound on the card
    as on the CPU within ``rtol = atol = 1e-5`` (reductions may associate
    differently), the same verdicts."""
    from repro_torch.kernels import registry
    rng = np.random.default_rng(7)
    xs = np.cumsum(rng.normal(size=(300, 17, 2)), 1).astype(np.float32)
    ys = np.cumsum(rng.normal(size=(300, 12, 2)), 1).astype(np.float32)
    lx, ly = rng.integers(1, 18, 300), rng.integers(1, 13, 300)
    eps = rng.uniform(0, 8, 300).astype(np.float32)
    spec = registry.get_envelope(name)
    got = spec.batch(xs, ys, lx, ly, eps=eps, device=cuda_device)
    want = spec.batch(xs, ys, lx, ly, eps=eps, device="cpu")
    torch.testing.assert_close(got.dist.cpu(), want.dist, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got.pruned.cpu(), want.pruned)


@pytest.mark.gpu
@pytest.mark.parametrize("name,lb", [("levenshtein", "off"),
                                     ("erp", "off"), ("erp", "envelope")])
def test_device_range_query_on_the_card_matches_the_cpu(cuda_device, name,
                                                        lb):
    """The one-shot flattened-net query: hits and every stats key equal on
    the card and on the CPU; one pivot launch plus one survivor launch."""
    from repro_torch.core.counter import CountedDistance
    from repro_torch.core.distributed import (device_range_query,
                                              flatten_net)
    from repro_torch.core.refnet import ReferenceNet
    from repro_torch.data import synthetic
    from repro_torch.distances import get
    gen = synthetic.proteins if name == "levenshtein" \
        else synthetic.trajectories
    data = gen(400, seed=8)
    net = ReferenceNet(get(name), data, tight_bounds=True,
                       counter=CountedDistance(get(name), data,
                                               device="cpu")).build_batched()
    flat = flatten_net(net)
    qs = data[::40].copy()
    eps = 2.0 if name == "levenshtein" else 1.0
    before = wf.LAUNCHES
    got, gst = device_range_query(flat, qs, eps, lb_cascade=lb,
                                  device=cuda_device)
    launches = wf.LAUNCHES - before
    want, wst = device_range_query(flat, qs, eps, lb_cascade=lb,
                                   device="cpu")
    np.testing.assert_array_equal(got, want)
    assert gst == wst and got.any()
    assert launches == 1 + (gst["member_evals"] > 0)


@pytest.mark.gpu
def test_comparison_indexes_on_the_card_match_the_cpu(cuda_device):
    """One MV build and one cover-tree query on the card: every counted
    dispatch is one launch, and hits, counts, references and the MV table
    equal the numpy backend's on the CPU (Levenshtein: exact)."""
    from repro_torch.core.counter import CountedDistance
    from repro_torch.core.covertree import CoverTree
    from repro_torch.core.refindex import MVReferenceIndex
    from repro_torch.data.synthetic import proteins
    from repro_torch.distances import get
    data = proteins(600, seed=3)
    lev = get("levenshtein")

    def counter(dev, backend="kernel"):
        return CountedDistance(lev, data, backend=backend, device=dev)

    before = wf.LAUNCHES
    mv = MVReferenceIndex(lev, data, n_refs=8,
                          counter=counter(cuda_device)).build()
    assert wf.LAUNCHES - before == mv.counter.build_dispatches > 0
    want = MVReferenceIndex(lev, data, n_refs=8,
                            counter=counter("cpu", "numpy")).build()
    assert mv.refs == want.refs
    np.testing.assert_array_equal(mv.table, want.table)

    ct = CoverTree(lev, data, counter=counter(cuda_device)).build_batched()
    ref = CoverTree(lev, data, counter=counter("cpu", "numpy")
                    ).build_batched()
    before = wf.LAUNCHES
    hits = ct.range_query(data[17], 3.0)
    assert wf.LAUNCHES - before == ct.counter.dispatches > 0
    assert hits == ref.range_query(data[17], 3.0) and 17 in hits
    assert (ct.counter.count, ct.counter.build_count) == \
        (ref.counter.count, ref.counter.build_count)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_recurrent_decode_matches_forward_on_the_card(cuda_device, arch):
    """Reduced Mamba2 and the hybrid in f32 on the card, seeded weights:
    a decode step after a prefill of S-1 tokens (the prefill padded to a
    chunk multiple) gives ``forward``'s logits at S-1, within the
    reference's ``rtol = 2e-2, atol = 2e-3``; neither hand-written kernel
    is launched."""
    from repro_torch.models import registry
    from repro_torch.models.common import grow_cache
    from repro_torch.models.params import init_params
    cfg, mod = registry.get(arch, reduced=True)
    gen = torch.Generator(cuda_device).manual_seed(2)
    model = mod.build(cfg, init_params(mod.param_defs(cfg), gen,
                                       torch.float32, cuda_device),
                      device=cuda_device)
    S = 21
    tokens = torch.randint(0, cfg.vocab, (2, S), generator=gen,
                           device=cuda_device)
    before = (wf.LAUNCHES, pl2.LAUNCHES)
    logits = mod.forward(model, {"tokens": tokens}, cfg)
    _, cache = mod.forward(model, {"tokens": tokens[:, :S - 1]}, cfg,
                           return_cache=True)
    assert cache["state"].dtype == torch.float32
    lg, cache = mod.decode_step(model, grow_cache(cache, S + 4),
                                tokens[:, S - 1:], cfg)
    torch.testing.assert_close(lg[:, 0], logits[:, S - 1], rtol=2e-2,
                               atol=2e-3)
    assert int(cache["pos"]) == S - 1
    assert (wf.LAUNCHES, pl2.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_flop_count_on_the_card_equals_meta(cuda_device, kind):
    """The reduced smollm-360m forward (prefill) and train step: the flops
    ``count_flops`` counts as they run on the card equal the dry-run's
    count on ``meta`` at the same shape."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    from repro_torch.models.params import init_params
    from repro_torch.roofline import costs
    cfg, mod = registry.get("smollm-360m", reduced=True)
    shape = ShapeConfig("cut", 64, 2, kind)
    rec = dryrun.measure("smollm-360m", shape, ("h100x1",),
                         dtype=torch.float32, reduced=True)[0]
    g = torch.Generator(cuda_device).manual_seed(0)
    model = mod.build(cfg, init_params(mod.param_defs(cfg), g,
                                       torch.float32, cuda_device),
                      dtype=torch.float32, device=cuda_device)
    model.requires_grad_(kind == "train")
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=g,
                              device=cuda_device, dtype=torch.int32)
             for k in (("tokens", "labels") if kind == "train"
                       else ("tokens",))}
    inputs = {"batch": batch}
    if kind == "train":
        inputs["opt"] = dryrun.opt_state(cfg, mod, model)
    flops, out = costs.count_flops(dryrun.step_fn(cfg, mod, kind), model,
                                   inputs)
    assert flops == rec["flops"] > 0
    if kind == "prefill":
        assert bool(torch.isfinite(out[0]).all())
