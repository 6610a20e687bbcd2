"""The port's pairwise-L2 entry point against the JAX reference's.

Same seeded numpy inputs go through ``repro.kernels.ops.pairwise_l2`` (the
Pallas kernel in interpret mode for one small case, its jnp oracle
``pairwise_l2_ref`` otherwise) and through ``repro_torch.kernels.ops`` on the
CPU, where the wrapper runs the kernel's plain torch version.

Tolerance: distances agree to ``rtol = 1e-3, atol = 1e-4`` where ``D > 1e-2``
(the reference suite's own).  Squared distances agree everywhere, planted
identical rows included, within ``(4d + 6) 2^-24 (|x|^2 + |y|^2)``: the
worst-case f32 error of two evaluations of the norm-and-dot formula, each
within ``(2d + 3) u (|x|^2 + |y|^2)`` of the exact value.  Near ``D = 0`` the
square root magnifies that rounding, so distances themselves are not held
there.  The CUDA kernel is held against the plain version on the card in
``test_torch_kernel_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pairwise_l2 as pl2  # noqa: E402

#: the shapes of the reference's kernel tests, plus ragged edges and the
#: odd widths the CUDA kernel's guards must take
SHAPES = [(1, 1, 3), (16, 16, 8), (37, 51, 19), (128, 128, 64), (130, 5, 33),
          (65, 67, 1), (70, 3, 961)]


def sq_bound(x, y):
    d = x.shape[1]
    return (4 * d + 6) * 2.0 ** -24 * (
        (x.astype(np.float64) ** 2).sum(1)[:, None]
        + (y.astype(np.float64) ** 2).sum(1)[None, :])


def check(got, want, x, y):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape == (x.shape[0], y.shape[0])
    assert np.isfinite(got).all()
    assert (np.abs(got ** 2 - want ** 2) <= sq_bound(x, y)).all()
    far = want > 1e-2
    np.testing.assert_allclose(got[far], want[far], rtol=1e-3, atol=1e-4)


def operands(M, N, d, seed, planted=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, d)).astype(np.float32)
    y = rng.normal(size=(N, d)).astype(np.float32)
    y[:planted] = x[:planted]  # exact duplicates: D = 0
    return x, y


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_reference(shape):
    M, N, d = shape
    x, y = operands(M, N, d, seed=M * N + d, planted=min(M, N) // 2)
    got = ops.pairwise_l2(x, y, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    check(got.numpy(), ref_ops.pairwise_l2_ref(x, y), x, y)


def test_plain_version_matches_interpret_mode_pallas_kernel():
    x, y = operands(37, 51, 19, seed=3, planted=5)
    check(ops.pairwise_l2(x, y, device="cpu").numpy(),
          ref_ops.pairwise_l2(x, y, interpret=True), x, y)


def test_unit_vectors_with_planted_near_duplicates():
    """The embedding case: unit rows at d = 960, exact and near duplicates
    (distance ~0 and ~1e-3) among random pairs (distance ~sqrt(2))."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(40, 960)).astype(np.float32)
    y = rng.normal(size=(90, 960)).astype(np.float32)
    y[:20] = x[:20]
    y[20:40] = x[20:40] + 3e-5 * rng.normal(size=(20, 960))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    got = ops.pairwise_l2(x, y, device="cpu").numpy()
    check(got, ref_ops.pairwise_l2_ref(x, y), x, y)
    # exact twins: the squared distance is within rounding of 0
    diag = np.arange(20)
    assert (got[diag, diag] ** 2 <= sq_bound(x, y)[diag, diag]).all()


def test_oracle_and_entry_points():
    """``ops.pairwise_l2_ref`` (float64 direct differences) bounds the
    plain version; tensors stay on their device; empty operands give an
    empty matrix; the default device is the card."""
    x, y = operands(9, 11, 5, seed=1)
    exact = ops.pairwise_l2_ref(x, y, device="cpu").numpy()
    check(pl2.pairwise_l2(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
          exact, x, y)
    assert ops.pairwise_l2(torch.as_tensor(x), y).device.type == "cpu"
    assert ops.pairwise_l2(x[:0], y, device="cpu").shape == (0, 11)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ops.pairwise_l2(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        pl2.pairwise_l2_cuda(torch.as_tensor(x), torch.as_tensor(y))


# -- the CUDA kernel's 3xTF32 arithmetic, emulated on the CPU ------------------
#
# ``csrc/pairwise_l2.cu`` splits each f32 operand v into big = rna_tf32(v) and
# small = rna_tf32(v - big) and sums big.small + small.big + big.big on the
# tensor cores into an f32 accumulator.  Its source note derives
# |D^2 - exact| <= (7d + 19 + 6d 2^-8) 2^-24 (|x|^2 + |y|^2); the emulation
# below runs the same split and products (exact in f32) with a sequential
# f32 accumulation, and is held to that bound against float64.


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, by bit operations: what ``cvt.rna.tf32.f32`` does."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def emulate_tf32(x, y, passes):
    """Squared distances as the kernel forms them, with ``passes`` = 3
    (big.small, small.big, big.big per k) or 1 (big.big only: one TF32
    product)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    xb, yb = tf32_rna(x), tf32_rna(y)
    xs, ys = tf32_rna(x - xb), tf32_rna(y - yb)
    acc = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float32)
    for k in range(x.shape[1]):
        if passes == 3:
            acc = acc + xb[:, k, None] * ys[None, :, k]
            acc = acc + xs[:, k, None] * yb[None, :, k]
        acc = acc + xb[:, k, None] * yb[None, :, k]
    xn = (x * x).sum(1)
    yn = (y * y).sum(1)
    d2 = xn[:, None] + yn[None, :] - 2.0 * acc
    return torch.sqrt(torch.clamp_min(d2, 0.0)).double() ** 2


def kernel_sq_bound(x, y):
    """The kernel's derived worst case against exact squared distances."""
    d = x.shape[1]
    return (7 * d + 19 + 6 * d * 2.0 ** -8) * 2.0 ** -24 * (
        (x.astype(np.float64) ** 2).sum(1)[:, None]
        + (y.astype(np.float64) ** 2).sum(1)[None, :])


def adversarial_operands(d, seed):
    """Unit rows with planted exact and 1e-4 duplicates, rows whose entries
    spread over 2^-20 .. 2^20, and rows whose every entry sits 0.49 TF32
    units above a TF32 value (so one TF32 product rounds all of them the
    same way), each planted again in y."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(24, d))
    y = rng.normal(size=(40, d))
    y[:4] = x[:4]                                       # exact twins
    y[4:8] = x[4:8] + 1e-4 * rng.normal(size=(4, d))    # near twins
    x[8:16] *= 2.0 ** rng.uniform(-20, 20, size=(8, d))  # mixed magnitudes
    y[8:16] = x[8:16] * (1 + 1e-3 * rng.normal(size=(8, d)))
    mag = 2.0 ** rng.integers(-6, 6, size=(8, d))       # one-sided rounding
    x[16:24] = mag * (1 + 0.49 * 2.0 ** -10) * np.sign(rng.normal(size=(8, d)))
    y[16:24] = x[16:24]
    x[:8] /= np.linalg.norm(x[:8], axis=1, keepdims=True)
    y[:8] /= np.linalg.norm(y[:8], axis=1, keepdims=True)
    return x.astype(np.float32), y.astype(np.float32)


def exact_sq(x, y):
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    return ((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1)


@pytest.mark.parametrize("d", [1, 3, 960, 961])
def test_3xtf32_emulation_holds_the_derived_bound(d):
    x, y = adversarial_operands(d, seed=d)
    err = np.abs(emulate_tf32(x, y, passes=3).numpy() - exact_sq(x, y))
    assert (err <= kernel_sq_bound(x, y)).all(), \
        float((err / kernel_sq_bound(x, y)).max())


@pytest.mark.parametrize("d", [1, 3, 960, 961])
def test_one_tf32_product_breaks_the_bound(d):
    """The tolerance is not vacuous: without the split, the one-sided rows
    land past it."""
    x, y = adversarial_operands(d, seed=d)
    err = np.abs(emulate_tf32(x, y, passes=1).numpy() - exact_sq(x, y))
    assert (err > kernel_sq_bound(x, y)).any()


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10
    v = torch.tensor([one + 0.49 * ulp, one + 0.5 * ulp, one + 0.51 * ulp,
                      -(one + 0.5 * ulp), 3.0, 0.0], dtype=torch.float32)
    got = tf32_rna(v).tolist()
    assert got == [one, one + ulp, one + ulp, -(one + ulp), 3.0, 0.0]
