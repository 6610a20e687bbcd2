"""The wavefront kernel's schedules on the card (``gpu`` marker; skipped
without a card).  Imports only the port, so it runs on a machine without
JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_traj_dfd_l64_gpu.py

``wavefront.schedule`` is the library's own choice at every shape tried,
and puts rows of 32 points or more on the block schedule (one warp a row,
several rows a block); ``SCHEDULE_ROWS`` counts each launch's rows under
the schedule it took; a launch on the block schedule is a
``wavefront.block`` span, one on the row schedule none; and the cell's
shape, 64 x 64 x 2, over many blocks and a partial last one, equals the
plain version at every kind of ε.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.kernels import wavefront as wf  # noqa: E402
from test_torch_kernel_gpu import assert_same_as_plain, eps_kinds  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_schedule_is_the_library_choice(cuda_device):
    for mode in ("dtw", "erp", "dfd", "lev"):
        for d in ((1,) if mode == "lev" else (1, 2, 8, 60, 300)):
            for Lx, Ly in ((7, 7), (20, 20), (31, 40), (31, 1000),
                           (32, 32), (64, 64), (90, 30)):
                rows = wf.smem_bytes(mode, Lx, Ly, d)[1]
                assert wf.schedule(mode, Lx, Ly, d) == (
                    "rows" if rows else "block"), (mode, Lx, Ly, d)


@pytest.mark.gpu
@pytest.mark.parametrize("Lx, want", [(31, "rows"), (32, "block"),
                                      (64, "block")])
def test_schedule_by_row_length(cuda_device, Lx, want):
    assert wf.schedule("dfd", Lx, Lx, 2) == want


def _launch(dev, B, L, d=2):
    g = torch.Generator().manual_seed(B + L)
    xs = torch.randn(B, L, d, generator=g).to(dev)
    ys = torch.randn(B, L, d, generator=g).to(dev)
    lens = torch.full((B, 2), L, dtype=torch.int32, device=dev)
    eps = torch.full((B,), float("inf"), device=dev)
    dist, _, _ = wf.wavefront_cuda(xs, ys, lens, eps, mode="dfd")
    want, _, _ = wf.wavefront_torch(xs, ys, lens, eps, mode="dfd")
    assert torch.equal(dist, want)


@pytest.mark.gpu
def test_schedule_rows_count_rows_by_schedule(cuda_device):
    before = dict(wf.SCHEDULE_ROWS)
    spans.reset()
    spans.enable()
    try:
        _launch(cuda_device, 37, 20)      # rows
        _launch(cuda_device, 11, 64)      # block
        _launch(cuda_device, 5, 32)       # block
        torch.cuda.synchronize()
        names = list(spans.records().name)
    finally:
        spans.disable()
        spans.reset()
    assert wf.SCHEDULE_ROWS["rows"] - before["rows"] == 37
    assert wf.SCHEDULE_ROWS["block"] - before["block"] == 16
    assert names == ["wavefront.block", "wavefront.block"]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2100, 2101])
def test_block_schedule_at_the_cell_shape(cuda_device, B):
    """traj-dfd-l64's rows (``dfd``, 64 x 64 x 2, ragged, seeded content
    past the lengths) in blocks of several rows: 2,101 leaves the last block
    partial.  ``dist``, ``hit`` and ``pruned`` equal the plain version's at
    ε of every kind."""
    g = np.random.default_rng(B)
    xs = np.cumsum(g.normal(scale=0.3, size=(B, 64, 2)), 1)
    ys = xs[:, :1] + np.cumsum(g.normal(scale=0.3, size=(B, 64, 2)), 1)
    lens = np.stack([g.integers(40, 65, B), g.integers(40, 65, B)], 1)
    lens[0] = 64
    ops = [torch.as_tensor(a.astype(np.float32), device=cuda_device)
           for a in (xs, ys)]
    ops.append(torch.as_tensor(lens.astype(np.int32), device=cuda_device))
    inf = torch.full((B,), float("inf"), device=cuda_device)
    exact = wf.wavefront_torch(*ops, inf, mode="dfd")[0]
    for kind, eps in eps_kinds(exact).items():
        got = assert_same_as_plain("dfd", ops, eps)
        assert torch.equal(got[0][got[1]], exact[got[1]]), kind
    mid = torch.quantile(exact, 0.5).expand(B).contiguous()
    got = assert_same_as_plain("dfd", ops, mid)
    assert got[1].any() and got[2].any() and (~got[1] & ~got[2]).any()
