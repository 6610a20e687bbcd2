"""Levenshtein token ids of the whole int32 range on the port's default
backend, against the JAX reference's default (numpy, exact integers).

The port's ``kernel`` backend carries Levenshtein tokens into the wavefront
as int32 ids (compared as integers by the kernel and by its plain version),
converted and range-checked once where a table or a query enters: the
counter's window table and query rows, the flattened net's upload.  Before,
it cast them to f32, where
ids of ``2**24`` and above round together: the case below gave 2.0 where
the reference gives 4.0.  Ids outside int32 are refused with ``ValueError``
wherever the ``kernel`` backend receives tokens.  Distances are exact
integers: compared for equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.retrieval as ref  # noqa: E402
from repro.core.counter import CountedDistance as RefCounted  # noqa: E402
from repro.distances import get as ref_get  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core.counter import CountedDistance  # noqa: E402
from repro_torch.core.refnet import ReferenceNet  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    protein_sequences, proteins)
from repro_torch.distances import get  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels import wavefront as wf  # noqa: E402
from repro_torch.retrieval import RetrievalConfig, Retriever  # noqa: E402

TOP = (1 << 31) - 1
#: (x, y): four ids each, pairwise distinct, so the distance is 4; f32
#: rounds some x[i] and y[i] to one value (spacing 2 at 2**24, 128 near
#: 2**31)
CASES = {
    "2**24": ([(1 << 24) + 2 * i for i in range(4)],
              [(1 << 24) + 2 * i + 1 for i in range(4)]),
    "2**31-1": ([TOP - 2 * i for i in range(4)],
                [TOP - 2 * i - 1 for i in range(4)]),
}
#: token maps of the retrieval case: the protein alphabet moved up
SHIFTS = {"2**24": lambda t: t + (1 << 24),
          "2**31-1": lambda t: TOP - t}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["kernel", "torch", "numpy"])
def test_large_ids_count_as_distinct_on_every_backend(case, backend):
    x, y = (np.asarray(v, np.int64) for v in CASES[case])
    data = np.stack([x, y])
    want = RefCounted(ref_get("levenshtein"), data).eval(x, [1])
    got = CountedDistance(get("levenshtein"), data, backend=backend,
                          device="cpu").eval(x, [1])
    assert float(want[0]) == 4.0
    np.testing.assert_array_equal(got, want)
    # f32 would have merged pairs: the ids are not exact as floats
    assert (x.astype(np.float32) == y.astype(np.float32)).any()


@pytest.mark.parametrize("case", sorted(SHIFTS))
def test_retriever_range_query_on_large_ids_matches_reference(case):
    """The quickstart's planted query over sequences whose token ids sit at
    ``2**24`` and up, or just below ``2**31``: the port's default backend
    gives the reference default's hits, distances and counts."""
    shift = SHIFTS[case]
    seqs = [shift(s.astype(np.int64))
            for s in protein_sequences(6, 120, n_motifs=48, seed=1)]
    rng = np.random.default_rng(0)
    q = seqs[3][40:76].copy()
    q[5] = shift(np.int64((rng.integers(0, 20) + 1) % 20))
    kw = dict(lam=16, lambda0=1, index="refnet", tight_bounds=True)
    port = Retriever.build(RetrievalConfig("levenshtein", device="cpu",
                                           **kw), seqs)
    refr = ref.Retriever.build(ref.RetrievalConfig("levenshtein", **kw),
                               seqs)
    assert port.config.backend == "kernel"
    assert refr.config.backend == "numpy"
    got, want = port.query(q).range(2.0), refr.query(q).range(2.0)
    assert [m.key() + (m.distance,) for m in got.hits] \
        == [m.key() + (m.distance,) for m in want.hits]
    assert got.hits and got.stats["query"] == want.stats["query"]


def test_ids_outside_int32_are_refused_wherever_the_kernel_takes_tokens():
    lev = get("levenshtein")
    ok = np.arange(8, dtype=np.int64).reshape(2, 4)
    bad = ok.copy()
    bad[1, 2] = 1 << 31
    with pytest.raises(ValueError, match="int32"):
        CountedDistance(lev, bad, device="cpu")
    counter = CountedDistance(lev, ok, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        counter.extend(bad[1:])
    assert counter.n == 2
    with pytest.raises(ValueError, match="int32"):
        counter.eval(bad[1], [0, 1])
    low = ok.copy()
    low[0, 0] = -(1 << 31) - 1
    with pytest.raises(ValueError, match="int32"):
        counter.eval(low[0], [0])
    with pytest.raises(ValueError, match="whole numbers"):
        counter.eval(ok[0] + 0.5, [0])
    assert counter.count == 0
    with pytest.raises(ValueError, match="int32"):
        Retriever.build(RetrievalConfig("levenshtein", lam=4,
                                        device="cpu"), [bad[1]])
    # the other backends take any integer, as the reference does
    assert CountedDistance(lev, bad, backend="numpy").eval(
        bad[1], [1])[0] == 0.0


def test_lev_operand_gives_int32_ids_and_the_wavefront_takes_only_those():
    ids = np.array([[0, -1, 1 << 24, (1 << 24) + 1, TOP, -(1 << 31)]])
    t = wf.lev_operand(ids, "cpu")
    assert t.dtype == torch.int32 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), ids)
    assert wf.lev_operand(t) is t  # int32: neither checked nor copied
    whole = wf.lev_operand(np.array([[3.0, -7.0]]), "cpu")  # by value
    np.testing.assert_array_equal(whole.numpy(), [[3, -7]])
    # some of these ids are NaNs as f32 bit patterns: compared as
    # integers, each equals itself and differs from every other
    assert torch.isnan(t.view(torch.float32)).any()
    lens = torch.tensor([[6, 6]], dtype=torch.int32)
    inf = torch.full((1,), float("inf"))
    same = wf.wavefront(t, t, lens, inf, mode="lev")[0]
    swap = wf.wavefront(t, t.flip(1).contiguous(), lens, inf, mode="lev")[0]
    assert float(same) == 0.0 and float(swap) == 6.0
    # f32 operands are not token ids here: refused, never reinterpreted
    f = t.to(torch.float32)
    with pytest.raises(ValueError, match="int32"):
        wf.wavefront(f, f, lens, inf, mode="lev")
    with pytest.raises(ValueError, match="int32"):
        wf.wavefront_torch(t, f, lens, inf, mode="lev")


def _spy_lev_operand(monkeypatch):
    """Record what reaches the kernel registry's token conversion: (numpy
    or tensor, dtype) of every operand."""
    seen = []

    def spy(a, device=None):
        seen.append((type(a).__name__, str(a.dtype)))
        return wf.lev_operand(a, device)

    monkeypatch.setattr(registry, "lev_operand", spy)
    return seen


def test_counter_converts_queries_once_and_its_table_stays_int32(
        monkeypatch):
    """Query rows are checked and made int32 once, in ``eval_stacked``;
    the dispatch then neither scans nor converts them again, and the window
    table on the device is int32 from its construction."""
    x, y = (np.asarray(v, np.int64) for v in CASES["2**24"])
    counter = CountedDistance(get("levenshtein"), np.stack([x, y]),
                              device="cpu")
    assert counter._data_t.dtype == torch.int32
    seen = _spy_lev_operand(monkeypatch)
    got = counter.eval_stacked(np.stack([x, x]), [0, 1], 4)
    np.testing.assert_array_equal(got, [0.0, 4.0])
    assert seen == [("ndarray", "int32"), ("Tensor", "torch.int32")]


def test_flat_net_uploads_token_ids_once_as_int32(monkeypatch):
    """The one-shot query's window table and pivots go up as int32 when the
    flat net reaches the device (range-checked there), and its queries
    when they enter: both launches see int32 operands only, and the hits
    are the brute-force oracle's at ids of ``2**24`` and up."""
    lev = get("levenshtein")
    data = proteins(60, seed=8).astype(np.int64) + (1 << 24)
    net = ReferenceNet(lev, data, eps_prime=1.0, tight_bounds=True,
                       counter=CountedDistance(lev, data, device="cpu")
                       ).build()
    flat = dist_mod.flatten_net(net)
    arrs = flat.device_arrays(torch.device("cpu"))
    assert arrs["data"].dtype == arrs["pivots"].dtype == torch.int32
    seen = _spy_lev_operand(monkeypatch)
    qs = data[:4].copy()
    qs[:, 3] += 1  # one substitution each, off the f32 grid of 2**24
    hits, st = dist_mod.device_range_query(flat, qs, 1.0, device="cpu")
    np.testing.assert_array_equal(
        hits, dist_mod.host_reference_hits(flat, qs, 1.0))
    assert hits[np.arange(4), np.arange(4)].all()
    assert seen and all(s == ("Tensor", "torch.int32") for s in seen)
    bad = dist_mod.flatten_net(net)
    bad.data = bad.data.copy()
    bad.data[0, 0] = 1 << 31
    with pytest.raises(ValueError, match="int32"):
        bad.device_arrays(torch.device("cpu"))
    with pytest.raises(ValueError, match="int32"):
        dist_mod.device_range_query(flat, qs + (1 << 31), 1.0, device="cpu")
