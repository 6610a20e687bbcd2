"""The wavefront kernel's schedules on the card (``gpu`` marker; skipped
without a card).  Imports only the port, so it runs on a machine without
JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_traj_dfd_l64_gpu.py

``wavefront.schedule`` is the library's own choice at every shape tried,
and puts rows of 32 points or more on the block schedule;
``SCHEDULE_ROWS`` counts each launch's rows under the schedule it took;
and a launch on the block schedule is a ``wavefront.block`` span, one on
the row schedule none.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.kernels import wavefront as wf  # noqa: E402


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
