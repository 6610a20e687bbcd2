"""The hand-written CUDA wavefront kernel against its plain torch version,
on the card (skipped without one).

Imports only the port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py

Tolerance: Levenshtein distances bit-equal; float modes ``rtol = atol =
1e-5`` (the two versions run the same f32 operations in the same order;
the plain version's run as separate CUDA kernels); hit and prune masks
equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels import wavefront as wf  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _ragged(string, B, Lx, Ly, rng, d):
    lx = rng.integers(1, Lx + 1, B)
    ly = rng.integers(1, Ly + 1, B)
    lx[0], ly[0] = Lx, Ly  # the dispatch's widths are the row maxima
    if string:
        xs = rng.integers(0, 6, size=(B, Lx))
        ys = rng.integers(0, 6, size=(B, Ly))
    else:
        xs = rng.normal(size=(B, Lx, d)).astype(np.float32)
        ys = rng.normal(size=(B, Ly, d)).astype(np.float32)
    for i in range(B):
        xs[i, lx[i]:] = 0
        ys[i, ly[i]:] = 0
    return xs, ys, lx, ly


@pytest.mark.gpu
@pytest.mark.parametrize("mode,B,Lx,Ly,d", [
    ("lev", 257, 22, 20, 1), ("erp", 129, 13, 9, 2), ("dtw", 64, 100, 80, 3),
    ("dfd", 33, 40, 31, 2), ("erp", 2, 1100, 1000, 2)])
def test_cuda_kernel_matches_plain_version(cuda_device, mode, B, Lx, Ly, d):
    rng = np.random.default_rng(B)
    xs, ys, lx, ly = _ragged(mode == "lev", B, Lx, Ly, rng, d)
    spec = registry.spec_for_mode(mode)
    ops, (Wx, Wy) = spec.layout(
        *(torch.as_tensor(a, device=cuda_device) for a in (xs, ys, lx, ly)))
    inf = torch.full((B,), float("inf"), device=cuda_device)
    exact = wf.wavefront_torch(*ops, inf, mode=mode, Lx=Wx, Ly=Wy)[0]
    eps = torch.quantile(exact, 0.5).expand(B).contiguous()
    before = wf.LAUNCHES
    got = wf.wavefront_cuda(*ops, eps, mode=mode, Lx=Wx, Ly=Wy)
    want = wf.wavefront_torch(*ops, eps, mode=mode, Lx=Wx, Ly=Wy)
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
    xs = np.zeros((4, 6), np.int64)
    ops, (Lx, Ly) = registry.get("levenshtein").layout(
        torch.as_tensor(xs, device=cuda_device),
        torch.as_tensor(xs, device=cuda_device),
        torch.full((4,), 6, device=cuda_device),
        torch.full((4,), 6, device=cuda_device))
    eps = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        wf.wavefront_cuda(*ops, eps.double(), mode="lev", Lx=Lx, Ly=Ly)
    with pytest.raises(ValueError, match="contiguous"):
        bad = list(ops)
        bad[1] = ops[1].transpose(0, 1).contiguous().transpose(0, 1)
        wf.wavefront_cuda(*bad, eps, mode="lev", Lx=Lx, Ly=Ly)
    with pytest.raises(ValueError, match="shape"):
        wf.wavefront_cuda(*ops, eps, mode="lev", Lx=Lx, Ly=Ly + 1)


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
