"""The port's wavefront kernel path against the JAX reference.

Same seeded numpy inputs go through ``repro``'s kernel registry (the
``lax.scan`` twin, bit-identical to the banded Pallas kernel, plus one case
through interpret-mode Pallas) and through ``repro_torch``'s registry on the
CPU, where the wrapper runs the kernel's plain torch version.

Tolerance: Levenshtein distances are bit-equal; float modes agree to
``rtol = atol = 1e-6``.  Both sides run the same f32 operations in the same
order on the CPU; the only freedom is the order of XLA's sum over the
feature axis (``d``) and of its border cumsum, which can move a last bit.
Hit and prune masks are equal.  The port is bit-equal to the reference's
numpy lane (``tests/test_torch_numpy_order.py``) and held to this jnp lane
by the tolerance above.  The CUDA kernel itself is held against its
plain version on the card in ``test_torch_kernel_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distances import get as ref_get  # noqa: E402
from repro.distances import np_backend  # noqa: E402
from repro.kernels import dispatch as ref_dispatch  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro_torch.kernels import dispatch, registry  # noqa: E402
from repro_torch.kernels import wavefront as wf  # noqa: E402

MODES4 = ["dtw", "erp", "frechet", "levenshtein"]
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _ragged(name, B, Lx, Ly, rng, d=2):
    lx = rng.integers(1, Lx + 1, B)
    ly = rng.integers(1, Ly + 1, B)
    if ref_get(name).string:
        xs = rng.integers(0, 6, size=(B, Lx))
        ys = rng.integers(0, 6, size=(B, Ly))
    else:
        xs = rng.normal(size=(B, Lx, d)).astype(np.float32)
        ys = rng.normal(size=(B, Ly, d)).astype(np.float32)
    for i in range(B):
        xs[i, lx[i]:] = 0
        ys[i, ly[i]:] = 0
    return xs, ys, lx, ly


def _eps_mid(name, xs, ys, lx, ly):
    """A threshold strictly between achieved distances: stable verdicts."""
    want = np_backend.batch_for(name)(xs, ys, lx, ly)
    u = np.unique(want[np.isfinite(want)])
    return float(u[: max(2, len(u) // 2)].mean()) if len(u) > 1 \
        else float(u[0]) + 0.5


def _port(name, xs, ys, lx=None, ly=None, eps=None):
    out = registry.get(name).batch(xs, ys, lx, ly, eps=eps, device="cpu")
    return registry.KernelOut(*(t.numpy() for t in out))


def _assert_match(name, got, ref, ctx=""):
    if name == "levenshtein":
        np.testing.assert_array_equal(got.dist, ref.dist, err_msg=ctx)
    else:
        np.testing.assert_allclose(got.dist, ref.dist, err_msg=ctx,
                                   **FLOAT_TOL)
    np.testing.assert_array_equal(got.hit, ref.hit, err_msg=ctx)
    np.testing.assert_array_equal(got.pruned, ref.pruned, err_msg=ctx)


@pytest.mark.parametrize("name", MODES4)
def test_batch_matches_reference_ragged(name):
    """Ragged rows spread over the whole band, fused eps at a stable mid
    threshold (the shapes of the reference's tiled-parity test)."""
    rng = np.random.default_rng(21)
    xs, ys, lx, ly = _ragged(name, 9, 7, 6, rng)
    eps_v = np.full(9, _eps_mid(name, xs, ys, lx, ly), np.float32)
    ref = ref_registry.get(name).batch(xs, ys, lx, ly, eps=eps_v,
                                       exec="scan")
    got = _port(name, xs, ys, lx, ly, eps_v)
    _assert_match(name, got, ref)
    assert got.hit.any() and (~got.hit).any()


@pytest.mark.parametrize("name", ["dtw", "erp"])
def test_batch_matches_reference_multidim(name):
    """d=3 series, no eps: full distances."""
    rng = np.random.default_rng(8)
    xs, ys, lx, ly = _ragged(name, 6, 10, 9, rng, d=3)
    ref = ref_registry.get(name).batch(xs, ys, lx, ly, exec="scan")
    _assert_match(name, _port(name, xs, ys, lx, ly), ref)


def test_batch_matches_reference_band_boundary_rows():
    """Answer diagonals at 7, 8, 9 (the reference's band-boundary rows)."""
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(6, 6, 2)).astype(np.float32)
    ys = rng.normal(size=(6, 6, 2)).astype(np.float32)
    lx = np.array([3, 4, 4, 4, 5, 6])
    ly = np.array([4, 4, 5, 4, 4, 3])
    for i in range(6):
        xs[i, lx[i]:] = 0
        ys[i, ly[i]:] = 0
    eps_v = np.full(6, _eps_mid("dtw", xs, ys, lx, ly), np.float32)
    ref = ref_registry.get("dtw").batch(xs, ys, lx, ly, eps=eps_v,
                                        exec="scan")
    _assert_match("dtw", _port("dtw", xs, ys, lx, ly, eps_v), ref)


@pytest.mark.parametrize("name", MODES4)
def test_eps_mix_inf_finite_and_exact_boundary(name):
    """+inf rows opt out, finite rows prune, and a row whose eps equals its
    own distance is a hit (``res <= eps``) on both sides."""
    rng = np.random.default_rng(33)
    xs, ys, lx, ly = _ragged(name, 12, 9, 8, rng)
    exact = _port(name, xs, ys, lx, ly).dist
    eps_v = np.full(12, np.float32(np.quantile(exact, 0.3)))
    eps_v[0::3] = np.inf
    eps_v[1::3] = exact[1::3]
    ref = ref_registry.get(name).batch(xs, ys, lx, ly, eps=eps_v,
                                       exec="scan")
    got = _port(name, xs, ys, lx, ly, eps_v)
    _assert_match(name, got, ref)
    assert got.hit[0::3].all() and not got.pruned[0::3].any()
    assert got.hit[1::3].all()
    assert not got.pruned[got.hit].any()


@pytest.mark.parametrize("name,value,L", [("erp", 1e25, 48),
                                          ("dtw", 3e24, 32)])
def test_big_overflow_rows_saturate_like_reference(name, value, L):
    """Long, high-gap-mass rows: every sum saturates at BIG, never inf."""
    xs = np.full((8, L, 1), value, np.float32)
    ys = -xs
    ref = ref_registry.get(name).batch(xs, ys, exec="scan")
    got = _port(name, xs, ys)
    assert np.isfinite(got.dist).all()
    np.testing.assert_array_equal(got.dist, ref.dist)
    refe = ref_registry.get(name).batch(xs, ys, eps=1e6, exec="scan")
    gote = _port(name, xs, ys, eps=1e6)
    _assert_match(name, gote, refe)
    assert not gote.hit.any()


def test_interpret_mode_pallas_small_case():
    """One small case through the reference's interpret-mode Pallas kernel
    (seconds per call)."""
    rng = np.random.default_rng(2)
    xs, ys, lx, ly = _ragged("levenshtein", 4, 6, 5, rng)
    eps_v = np.full(4, _eps_mid("levenshtein", xs, ys, lx, ly), np.float32)
    ref = ref_registry.get("levenshtein").batch(
        xs, ys, lx, ly, eps=eps_v, exec="pallas", interpret=True)
    _assert_match("levenshtein", _port("levenshtein", xs, ys, lx, ly, eps_v),
                  ref)


@pytest.mark.parametrize("name", MODES4)
def test_packed_batch_meta_and_stats_match_reference(name):
    rng = np.random.default_rng(31)
    ref_dispatch.STATS.reset()
    dispatch.STATS.reset()
    for B in (11, 5):
        xs, ys, lx, ly = _ragged(name, B, 9, 7, rng)
        eps = _eps_mid(name, xs, ys, lx, ly)
        ref = ref_dispatch.packed_batch(name, xs, ys, lx, ly, eps=eps,
                                        exec="scan")
        got = dispatch.packed_batch(name, xs, ys, lx, ly, eps=eps,
                                    device="cpu")
        _assert_match(name, got, ref)
        assert dispatch.STATS.last_meta.buckets == \
            ref_dispatch.STATS.last_meta.buckets
        assert dispatch.STATS.last_meta.offsets == \
            ref_dispatch.STATS.last_meta.offsets
    for key in ("dispatches", "bucket_rounds", "rows", "pruned"):
        assert getattr(dispatch.STATS, key) == \
            getattr(ref_dispatch.STATS, key), key
    assert dispatch.STATS.pruned > 0


def test_pack_meta_is_a_stable_bucket_sort():
    lx = np.array([3, 1, 3, 2, 1])
    ly = np.array([2, 2, 1, 2, 2])
    order, meta = dispatch.pack_meta(lx, ly)
    assert list(order) == [1, 4, 3, 2, 0]
    assert meta.buckets == ((1, 2, 2), (2, 2, 1), (3, 1, 1), (3, 2, 1))
    assert meta.offsets == (0, 2, 3, 4)


def _unpadded(name, xs, ys, lx, ly):
    """The kernel's operands: rows as they are, int32 token ids or f32
    series ``(B, L, d)``, lengths ``(B, 2)`` int32."""
    if ref_get(name).string:
        xs, ys = (torch.as_tensor(a.astype(np.int32)) for a in (xs, ys))
    else:
        xs, ys = torch.as_tensor(xs), torch.as_tensor(ys)
    return xs, ys, torch.as_tensor(np.stack([lx, ly], 1).astype(np.int32))


@pytest.mark.parametrize("name", MODES4)
def test_plain_version_on_unpadded_operands_with_nonzero_padding(name):
    """Content past each row's own lengths is the dispatch's padding: it
    feeds the costs of the padding cells, and through them the prune
    certificate, exactly as in the reference's padded layout (ERP gaps are
    zeroed there, costs are not)."""
    rng = np.random.default_rng(44)
    B, Lx, Ly = 64, 9, 8
    xs, ys, lx, ly = _ragged(name, B, Lx, Ly, rng)
    lx[0], ly[0] = Lx, Ly  # the dispatch's widths are the row maxima
    for i in range(B):  # seeded non-zero padding
        if ref_get(name).string:
            xs[i, lx[i]:] = rng.integers(1, 6, Lx - lx[i])
            ys[i, ly[i]:] = rng.integers(1, 6, Ly - ly[i])
        else:
            xs[i, lx[i]:] = rng.normal(size=(Lx - lx[i], 2)) * 10
            ys[i, ly[i]:] = rng.normal(size=(Ly - ly[i], 2)) * 10
    exact = ref_registry.get(name).batch(xs, ys, lx, ly, exec="scan").dist
    eps_v = np.full(B, np.float32(np.quantile(exact, 0.4)))
    eps_v[0::4] = np.inf
    ref = ref_registry.get(name).batch(xs, ys, lx, ly, eps=eps_v,
                                       exec="scan")
    mode = registry.MODE_OF_NAME[name]
    got = wf.wavefront_torch(*_unpadded(name, xs, ys, lx, ly),
                             torch.as_tensor(eps_v), mode=mode)
    _assert_match(name, registry.KernelOut(*(t.numpy() for t in got)), ref)
    assert ref.pruned.any() and ref.hit.any()
    if name == "erp":  # zero gaps past the lengths carry the valid cells'
        return         # values into the padding: its content rarely shows
    # the padding matters: zeroing it changes some prune verdict
    zx, zy = xs.copy(), ys.copy()
    for i in range(B):
        zx[i, lx[i]:] = 0
        zy[i, ly[i]:] = 0
    zero = ref_registry.get(name).batch(zx, zy, lx, ly, eps=eps_v,
                                        exec="scan")
    assert (zero.pruned != ref.pruned).any()


def test_cpu_tensors_take_the_plain_version_cuda_wrapper_refuses_them():
    rng = np.random.default_rng(4)
    xs, ys, lx, ly = _ragged("erp", 5, 6, 6, rng)
    lx[0], ly[0] = 6, 6
    ops = _unpadded("erp", xs, ys, lx, ly)
    eps = torch.full((5,), float("inf"))
    before = wf.LAUNCHES
    got = wf.wavefront(*ops, eps, mode="erp")
    want = wf.wavefront_torch(*ops, eps, mode="erp")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wf.wavefront_cuda(*ops, eps, mode="erp")
    assert wf.LAUNCHES == before


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
def test_levenshtein_tokens_of_any_dtype_reach_the_kernel_as_f32(
        dtype, monkeypatch):
    """Tokens ride as ``(B, L)`` int32 ids on every device (the reference
    casts them to f32, which is exact below ``2**24``, as here): the
    registry hands the kernel wrapper the same operands whatever the
    tokens' dtype, and the answers are the reference's."""
    rng = np.random.default_rng(45)
    xs, ys, lx, ly = _ragged("levenshtein", 16, 7, 6, rng)
    xs, ys = xs.astype(dtype), ys.astype(dtype)
    seen = []

    def spy(xs_t, ys_t, lens, eps, *, mode):
        seen.append((xs_t.dtype, ys_t.dtype, xs_t.shape, ys_t.shape))
        return wf.wavefront(xs_t, ys_t, lens, eps, mode=mode)

    monkeypatch.setattr(registry, "wavefront", spy)
    eps_v = np.full(16, _eps_mid("levenshtein", xs, ys, lx, ly), np.float32)
    got = _port("levenshtein", xs, ys, lx, ly, eps_v)
    assert seen == [(torch.int32, torch.int32, (16, 7), (16, 6))]
    ref = ref_registry.get("levenshtein").batch(xs, ys, lx, ly, eps=eps_v,
                                                exec="scan")
    _assert_match("levenshtein", got, ref)
