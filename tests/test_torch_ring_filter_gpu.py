"""The one-shot query's ring filter on the card against its plain version
(``gpu`` marker; skipped without a card).  Imports only the port, so it
runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ring_filter_gpu.py

The kernel and the plain version run the same f32 adds and comparisons, so
everything is held equal, byte for byte: the hit mask after pass 1, the
survivor count, ``q_of``/``w_of`` and their order, the query lengths and
the operand rows pass 2 writes.  Through ``device_range_query``, hits and
every stats key on the card equal the CPU path's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core.counter import CountedDistance  # noqa: E402
from repro_torch.core.refnet import ReferenceNet  # noqa: E402
from repro_torch.data.synthetic import proteins, trajectories  # noqa: E402
from repro_torch.distances import get  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels import ring_filter as rf  # noqa: E402

import ring_cases  # noqa: E402

EPS_PRIME = {"levenshtein": 1.0, "erp": 2.0, "frechet": 1.0, "dtw": 1.0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _both(dp, pradius, pivot, ids, mdist, eps, N, qs, q_lens, data):
    """The filter on the card and its plain version on the same card
    operands: ``[(hits after pass 1, n_need, rows)] * 2``."""
    out = []
    for f1, f2 in ((rf.ring_filter_cuda, rf.survivor_rows_cuda),
                   (rf.ring_filter_torch, rf.survivor_rows_torch)):
        hits = torch.zeros((dp.shape[0], N), dtype=torch.bool,
                           device=dp.device)
        v = f1(dp, pradius, pivot, ids, mdist, eps, hits)
        hits1 = hits.clone()
        n = int(v.n_need)
        rows = f2(v, n, qs, q_lens, data) if n else None
        out.append((hits1, n, rows))
    torch.cuda.synchronize()
    return out


def _assert_same(got, want):
    (gh, gn, gr), (wh, wn, wr) = got, want
    assert torch.equal(gh, wh)
    assert gn == wn
    if wn:
        for name, g, w in zip(rf.Rows._fields, gr, wr):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g, w), name


def _rows_of(kind, Q, N, Lq, L, dev, rng):
    """Query rows, their lengths and window rows of one dtype: int32 tokens
    (``lev``), f32 2-D series (``erp``) or bytes of odd width (``bytes``,
    the kernel's byte-copy path)."""
    if kind == "lev":
        qs = rng.integers(0, 20, (Q, Lq)).astype(np.int32)
        data = rng.integers(0, 20, (N, L)).astype(np.int32)
    elif kind == "erp":
        qs = rng.normal(size=(Q, Lq, 2)).astype(np.float32)
        data = rng.normal(size=(N, L, 2)).astype(np.float32)
    else:
        qs = rng.integers(0, 255, (Q, 7)).astype(np.uint8)
        data = rng.integers(0, 255, (N, 5)).astype(np.uint8)
    q_lens = rng.integers(1, qs.shape[1] + 1, Q).astype(np.int32)
    return [torch.as_tensor(a, device=dev) for a in (qs, q_lens, data)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lev", "erp", "bytes"])
@pytest.mark.parametrize("name", ring_cases.CASES)
def test_kernel_equals_plain_version(cuda_device, name, kind):
    """Synthetic rings with one giant list: random, ``eps`` exactly on
    ``dp +- mdist`` and ``dp +- pradius`` (``ties``), no survivor, every
    pair a survivor; rows of three dtypes."""
    dp, pr, members, md, eps = ring_cases.case(name, Q=37, P=29, N=5000)
    pv, ids, mdist = ring_cases.csr(members, md)
    dev = cuda_device
    t = [torch.as_tensor(a, device=dev) for a in (dp, pr, pv, ids, mdist)]
    rng = np.random.default_rng(3)
    qs, q_lens, data = _rows_of(kind, 37, 5000, 20, 20, dev, rng)
    got, want = _both(*t, eps, 5000, qs, q_lens, data)
    _assert_same(got, want)
    wh, q_of, w_of = ring_cases.padded(
        *[torch.as_tensor(a, device=dev) for a in (dp, pr, members, md)],
        eps, 5000)
    assert torch.equal(got[0], wh) and got[1] == len(q_of)
    if got[1]:
        assert torch.equal(got[2].q_of, q_of)
        assert torch.equal(got[2].w_of, w_of)
    if name == "ties":
        assert min(ring_cases.boundary_slots(dp, pr, members, md,
                                             eps).values()) > 0
    if name == "all":
        assert got[1] == 37 * len(ids)


def _merged(name, n=1200, seed=8):
    """A merged 4-shard fleet net (one giant pivot a shard, as the
    benchmark's fleets hold) and its windows.  DTW is no metric: its net is
    Frechet's, relinked with DTW's pivot-member distances."""
    gen = proteins if name == "levenshtein" else trajectories
    data = gen(n, seed=seed)
    metric = "frechet" if name == "dtw" else name
    flats = []
    for part in np.array_split(np.arange(n), 4):
        d = data[part]
        net = ReferenceNet(get(metric), d, eps_prime=EPS_PRIME[name],
                           tight_bounds=True,
                           counter=CountedDistance(get(metric), d,
                                                   device="cpu")
                           ).build_batched(max_cohort=256)
        flats.append(dist_mod.flatten_net(net))
    flat = dist_mod.merge_flats(flats)[0]
    runs = np.bincount(flat.mem_pivot, minlength=flat.n_pivots)
    assert runs.max() > 8 * runs.mean()
    if name == "dtw":
        md = registry.get("dtw").batch(
            data[flat.pivot_ids[flat.mem_pivot]], data[flat.mem_id],
            device="cpu").dist.numpy().astype(np.float32)
        radius = np.zeros(flat.n_pivots, np.float32)
        np.maximum.at(radius, flat.mem_pivot, md)
        flat = dist_mod.FlatNet(
            pivots=flat.pivots, pivot_radius=radius,
            mem_pivot=flat.mem_pivot, mem_id=flat.mem_id, mem_dist=md,
            data=flat.data, n_pivots=flat.n_pivots, dist_name="dtw",
            pivot_ids=flat.pivot_ids)
    return data, flat


def _queries(data, Q, rng):
    qs = data[rng.integers(0, len(data), Q)].copy()
    if qs.dtype.kind in "iu":
        flips = rng.random(qs.shape) < 0.1
        qs[flips] = rng.integers(0, int(data.max()) + 1, flips.sum())
    else:
        qs += rng.normal(scale=0.1, size=qs.shape).astype(qs.dtype)
    return qs


def _query_both(flat, qs, eps, dev, **kw):
    """The query on the card and on the CPU: equal hits and stats, one
    filter launched and one pass 2 when a survivor is left."""
    before, rows0 = rf.LAUNCHES, rf.ROW_LAUNCHES
    got, gst = dist_mod.device_range_query(flat, qs, eps, device=dev, **kw)
    launches, rows = rf.LAUNCHES - before, rf.ROW_LAUNCHES - rows0
    want, wst = dist_mod.device_range_query(flat, qs, eps, device="cpu",
                                            **kw)
    np.testing.assert_array_equal(got, want)
    assert gst == wst
    assert launches == 1
    assert rows == int(gst["member_evals"] > 0)
    return got, gst


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["levenshtein", "erp", "dtw", "frechet"])
def test_merged_fleet_ring_on_the_card(cuda_device, name):
    """On a merged fleet's own operands (``dp`` from the card's pivot
    launch, ragged query lengths): the kernel equals the plain version at
    an ``eps`` with survivors, at ``eps`` exactly ``dp + mdist`` and
    ``|dp - mdist|`` of a real pair, exactly ``dp +- pradius`` of a real
    pivot, and at f64 values no f32 holds beside a real pair's ``dp +-
    mdist`` in a list with no whole-list verdict (the kernel rounds
    ``eps`` to f32 as torch's comparison does); the whole query's hits and
    stats equal the CPU path's, there too."""
    data, flat = _merged(name)
    dev = cuda_device
    rng = np.random.default_rng(4)
    qs = _queries(data, 24, rng)
    q_lens = rng.integers(12, qs.shape[1] + 1, 24).astype(np.int32)
    q_lens[0] = qs.shape[1]
    arrs = flat.device_arrays(dev)
    qs_t = dist_mod._operand_of(flat.dist_name)(qs).to(dev).contiguous()
    ql_t = torch.as_tensor(q_lens, device=dev)
    P = flat.n_pivots
    spec = registry.get(name)
    dp = spec.device_call(qs_t.repeat_interleave(P, dim=0),
                          arrs["pivots"].repeat((24,) + (1,) * (
                              arrs["pivots"].ndim - 1)),
                          lx=ql_t.repeat_interleave(P)).dist.reshape(24, P)
    ring = (dp.contiguous(), arrs["pradius"], arrs["mem_pivot"],
            arrs["mem_id"], arrs["mem_dist"])
    dph = dp.cpu().numpy()
    j = int(np.argmax(arrs["mem_pivot"].cpu().numpy() == P // 2))
    p0, md0 = int(arrs["mem_pivot"][j]), float(arrs["mem_dist"][j])
    pr0 = float(flat.pivot_radius[p0])
    d0 = dph[3, p0]
    base = {"levenshtein": 2.0, "erp": 4.0, "dtw": 8.0, "frechet": 1.0}
    at = [base[name], float(np.float32(d0 + np.float32(md0))),
          float(np.float32(abs(d0 - np.float32(md0)))),
          float(np.float32(d0 + np.float32(pr0))),
          float(np.float32(d0 - np.float32(pr0)))]
    _, _, hi, lo = ring_cases.undecided_pair(
        dph, flat.pivot_radius, arrs["mem_pivot"].cpu().numpy(),
        arrs["mem_dist"].cpu().numpy(), rng)
    off = [ring_cases.between(b, f) for b in (hi, lo)
           for f in ring_cases.FRACTIONS]
    n_any = 0
    for eps in at + off:
        got, want = _both(*ring, eps, len(flat.data), qs_t, ql_t,
                          arrs["data"])
        _assert_same(got, want)
        n_any += got[1]
    assert n_any > 0
    for eps in (base[name], off[1]):
        _query_both(flat, qs, eps, dev, q_lens=q_lens)


@pytest.mark.gpu
@pytest.mark.parametrize("name,eps", [("levenshtein", 2.0), ("erp", 24.0)])
def test_device_range_query_at_the_benchmark_eps(cuda_device, name, eps):
    """The benchmark's cells' ``eps`` (2 over proteins under Levenshtein,
    24 over trajectories under ERP) on a merged fleet, 64 queries: hits
    and every stats key, the slot counter among them, equal on the card
    and on the CPU, with one filter launch."""
    data, flat = _merged(name)
    qs = _queries(data, 64, np.random.default_rng(5))
    got, st = _query_both(flat, qs, eps, cuda_device)
    assert st["filter_slots"] == 64 * len(flat.mem_id)
    assert st["member_evals"] > 0 and got.any()


@pytest.mark.gpu
def test_filter_after_remove_and_append(cuda_device):
    """A net after ``remove`` (its CSR drops the ids) and after
    ``append`` (the new windows answer): card equals CPU each time."""
    data, flat = _merged("levenshtein")
    qs = _queries(data, 16, np.random.default_rng(6))
    _query_both(flat, qs, 2.0, cuda_device)
    live = flat.mem_id
    gone = live[live % 7 == 0]
    flat.remove(gone)
    ids = flat.device_arrays(cuda_device)["mem_id"].cpu().numpy()
    assert not np.isin(gone, ids).any()
    hits, _ = _query_both(flat, qs, 2.0, cuda_device)
    assert not hits[:, gone].any()
    new = proteins(40, seed=21)
    pv = flat.pivots
    ds = registry.get("levenshtein").batch(
        np.repeat(new, len(pv), 0), np.tile(pv, (len(new), 1)),
        device="cpu").dist.numpy().reshape(len(new), len(pv))
    n0 = len(flat.data)
    flat.append(ds.argmin(axis=1), np.arange(n0, n0 + len(new)),
                ds.min(axis=1), new_data=new)
    qs2 = np.concatenate([qs, new[:8]])
    hits, _ = _query_both(flat, qs2, 2.0, cuda_device)
    assert hits[16 + np.arange(8), n0 + np.arange(8)].all()


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    dp, pr, members, md, eps = ring_cases.case("random")
    pv, ids, mdist = ring_cases.csr(members, md)
    dev = cuda_device
    t = [torch.as_tensor(a, device=dev) for a in (dp, pr, pv, ids, mdist)]
    hits = torch.zeros((len(dp), 300), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        rf.ring_filter_cuda(t[0].double(), *t[1:], eps, hits)
    with pytest.raises(ValueError, match="dtype"):
        rf.ring_filter_cuda(*t[:3], t[3].long(), t[4], eps, hits)
    with pytest.raises(ValueError, match="contiguous"):
        rf.ring_filter_cuda(t[0].t().contiguous().t(), *t[1:], eps, hits)
    with pytest.raises(ValueError, match="cuda"):
        rf.ring_filter_cuda(*[x.cpu() for x in t], eps, hits.cpu())
