"""The port's ``kernels.ops.wavefront`` against the JAX reference's.

Same seeded numpy inputs go through ``repro.kernels.ops.wavefront`` with
``exec="scan"`` (the ``lax.scan`` twin of the Pallas kernel, bit-identical
to it) and through ``repro_torch.kernels.ops.wavefront`` on the CPU, where
the registry runs the CUDA kernel's plain torch version.  The port's oracle
``ops.wavefront_ref`` is held to the reference's ``wavefront_ref``.

Tolerance: Levenshtein distances are bit-equal; float modes agree to
``1e-5`` (both run the same f32 recurrence; XLA may order the feature-axis
sum and ERP's border cumsum otherwise, which moves last bits along the
path).  Fused-ε hit and prune masks are equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

MODES = ["dtw", "erp", "dfd", "lev"]
TOL = dict(rtol=1e-5, atol=1e-5)


def operands(mode, B, Lx, Ly, d, seed):
    rng = np.random.default_rng(seed)
    if mode == "lev":
        return (rng.integers(0, 5, size=(B, Lx)).astype(np.int32),
                rng.integers(0, 5, size=(B, Ly)).astype(np.int32))
    return (rng.normal(size=(B, Lx, d)).astype(np.float32),
            rng.normal(size=(B, Ly, d)).astype(np.float32))


def same(mode, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if mode == "lev":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,Lx,Ly,d", [(7, 9, 9, 2), (5, 6, 11, 3),
                                       (4, 12, 5, 1)])
def test_wavefront_matches_reference(mode, B, Lx, Ly, d):
    xs, ys = operands(mode, B, Lx, Ly, d, seed=B * Lx + Ly)
    got = ops.wavefront(xs, ys, mode, device="cpu")
    assert got.shape == (B,) and got.dtype == torch.float32
    same(mode, got.numpy(), ref_ops.wavefront(xs, ys, mode, exec="scan"))
    same(mode, ops.wavefront_ref(xs, ys, mode, device="cpu").numpy(),
         ref_ops.wavefront_ref(xs, ys, mode))


@pytest.mark.parametrize("mode", MODES)
def test_ragged_fused_eps_matches_reference(mode):
    B, Lx, Ly = 12, 10, 8
    xs, ys = operands(mode, B, Lx, Ly, 2, seed=11)
    rng = np.random.default_rng(12)
    lx = rng.integers(1, Lx + 1, B)
    ly = rng.integers(1, Ly + 1, B)
    exact = np.asarray(ref_ops.wavefront(xs, ys, mode, lens_x=lx, lens_y=ly,
                                         exec="scan"))
    eps = np.float32(np.quantile(exact, 0.5))
    got = ops.wavefront(xs, ys, mode, lens_x=lx, lens_y=ly, eps=eps,
                        device="cpu")
    want = ref_ops.wavefront(xs, ys, mode, lens_x=lx, lens_y=ly, eps=eps,
                             exec="scan")
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.pruned.numpy(), np.asarray(want.pruned))
    same(mode, got.dist.numpy()[hit], np.asarray(want.dist)[hit])
    assert hit.any() and (~hit).any()


def test_interpret_mode_pallas_case_and_bad_mode():
    xs, ys = operands("erp", 3, 6, 6, 2, seed=5)
    same("erp", ops.wavefront(xs, ys, "erp", device="cpu").numpy(),
         ref_ops.wavefront(xs, ys, "erp", interpret=True))
    with pytest.raises(ValueError, match="mode"):
        ops.wavefront(xs, ys, "lcss", device="cpu")
