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
